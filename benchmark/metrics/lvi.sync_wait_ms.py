"""lvi.sync_wait_ms: ms an event (an ``lvi.image`` or ``lvi.lidar`` span)
in the ``host.sync`` spans (``core/hostsync``: the device wait and the
copy of each host read) of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("host.sync"), s.count(*_spans.ROOTS))
