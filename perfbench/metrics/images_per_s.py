"""images_per_s: images completed in the window over its wall (the window
holds whole dispatches: it opens and closes at completions)."""


def read(run):
    return run.images / run.window_s
