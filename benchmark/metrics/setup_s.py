"""setup_s (s): process start to the window's opening: imports, the
kernels' build (cached in the checkout after a first run), the lap made on
the card, the system built and warmed."""


def read(ctx):
    return ctx["setup_s"]
