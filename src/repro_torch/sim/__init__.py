"""Serving passes over the Ditto engine (``harness``)."""
