"""lvi.host_syncs_per_event: the program's host syncs
(``core/hostsync.COUNT``) over the window, an event."""


def read(ctx):
    win = ctx["win"]
    return win.counts["host_syncs"] / win.done if win.done else None
