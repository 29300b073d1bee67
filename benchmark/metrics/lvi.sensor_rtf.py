"""lvi.sensor_rtf (x_realtime): the sensor seconds of every event whose
output reached the host inside the window, over the window's wall seconds
(in a traced run the profiled stretch slows the host)."""


def read(ctx):
    win = ctx["win"]
    return win.sensor_s / win.wall_s if win.wall_s > 0 else None
