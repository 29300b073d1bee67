"""host_cpu_per_sensor_s (s/s): the CPU seconds the system's process spent
in the window, all its threads, over the sensor seconds it answered there:
the host computer the system needs for each second of sensor data."""


def read(ctx):
    win = ctx["win"]
    return win.cpu_s / win.sensor_s if win.sensor_s > 0 and win.cpu_s > 0 else None
