"""Fakes of the scheduler tests (tests/test_torch_scheduler.py and
tests/test_torch_async.py): a hand-driven clock and a duck-typed session
for either package, so the same scripted stream drives the reference's
``ServeScheduler`` and the port's through matching fakes."""
import time
import types

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.ditto import DittoPlan as RDittoPlan
from repro.core.ditto import PlanSchedule as RPlanSchedule
from repro.serve import scheduler as rscheduler
from repro.serve import faults as rfaults
from repro.serve.bucketing import bucket_for as rbucket_for
from repro.serve.session import ChunkResult as RChunkResult
from repro.serve.session import ServeResult as RServeResult
from repro_torch.core.ditto import DittoPlan, PlanSchedule
from repro_torch.serve import faults, scheduler
from repro_torch.serve.bucketing import bucket_for
from repro_torch.serve.session import ChunkResult, ServeResult

#: the two packages' modules, side by side
REF = types.SimpleNamespace(
    name="ref", DittoPlan=RDittoPlan, PlanSchedule=RPlanSchedule, scheduler=rscheduler,
    faults=rfaults, ServeScheduler=rscheduler.ServeScheduler, bucket_for=rbucket_for,
    full=lambda shape, v: jnp.full(shape, v, jnp.float32),
    numpy=np.asarray,
    result=lambda sample, b, bucket, wall: RServeResult(sample=sample, chunks=[RChunkResult(
        sample=sample, records=[], engine=None, batch=b, bucket=bucket, wall_s=wall,
        traces_delta=0)]))
PORT = types.SimpleNamespace(
    name="port", DittoPlan=DittoPlan, PlanSchedule=PlanSchedule, scheduler=scheduler,
    faults=faults, ServeScheduler=scheduler.ServeScheduler, bucket_for=bucket_for,
    full=lambda shape, v: torch.full(shape, v, dtype=torch.float32),
    numpy=lambda t: t.numpy(),
    result=lambda sample, b, bucket, wall: ServeResult(sample=sample, chunks=[ChunkResult(
        sample=sample, records=[], engine=None, batch=b, bucket=bucket, wall_s=wall,
        captures_delta=0)]))
PKGS = (REF, PORT)


class FakeClock:
    """The scheduler's clock, advanced by hand: poll()-driven tests see
    exact deadlines, not races."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def plan_summary(plan):
    """The fields a ladder rung may change, as a plain tuple."""
    return (plan.low_bits, plan.fused, plan.compiled)


class FakeSession:
    """Duck-typed ServeSession of package ``pkg``: ``serve`` is x -> 2x
    (bit-exact per row, so a ticket's rows are checkable) with the real
    bucket accounting, after the ``session.serve`` fault probe the real
    session fires; ``wall_s`` sleeps, ``fail`` raises."""

    def __init__(self, pkg, plan, wall_s=0.0, fail=False):
        self.pkg = pkg
        self.plan = plan
        self.wall_s = wall_s
        self.fail = fail
        self.calls = []  # (rows, plan_summary) per successful serve

    def serve(self, x, labels, plan=None):
        fault = self.pkg.faults.fire("session.serve")
        if fault is not None:
            self.pkg.faults.perform(fault)
        plan = self.plan if plan is None else plan
        if self.wall_s:
            time.sleep(self.wall_s)
        if self.fail:
            raise RuntimeError("injected dispatch failure")
        b = x.shape[0]
        self.calls.append((b, plan_summary(plan)))
        return self.pkg.result(x * 2.0, b, self.pkg.bucket_for(b, max_batch=plan.max_batch),
                               self.wall_s)

    def stats(self):
        return {}


def fake_scheduler(pkg, plan=None, *, wall_s=0.0, fail=False, **kw):
    """``pkg``'s ServeScheduler over a FakeSession (no params, no model)."""
    plan = plan if plan is not None else pkg.DittoPlan(steps=3, policy="diff", max_batch=4,
                                                        collect_stats=False)
    return pkg.ServeScheduler.from_session(FakeSession(pkg, plan, wall_s, fail), **kw)
