"""device_idle_share (%): the traced stretch's wall time in which no
operation ran on the device (1 - the union of the device intervals over
the stretch)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
