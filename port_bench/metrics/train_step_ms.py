"""Training: the mean host span of an optimizer step (``mnle.train_step``)
in the window, in milliseconds."""


def read(r):
    c = r.window
    if not c.steps:
        return None
    return c.step_s * 1e3 / c.steps
