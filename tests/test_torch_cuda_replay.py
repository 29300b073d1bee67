"""The fused replay's deferred readback on the card (`LviSystem._rp_readback`
and `_rp_wait`) with the outputs on a device other than the current one:
the copy runs on the stream of the outputs' device, so the event that the
host waits on must be recorded there. Marked `cuda`; skips without two
CUDA devices. Run on a GPU machine from the repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_replay.py`
(`--noconftest`: the test tree's conftest imports JAX).

Tolerance: none; the values read back equal the device's bit for bit."""

import types

import pytest
import torch

from lvislam_tpu_torch.models.pipeline import LviSystem

pytestmark = pytest.mark.cuda


def _chain(dev):
    """~0.5 s of matmuls on `dev`, then a (K, OUT_LEN) slice as a replay
    batch's outputs."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8192, 8192, device=dev, generator=gen)
    for _ in range(24):
        x = torch.tanh(x @ x * 1e-2)
    return x[:16, :48] + 1.0


def test_readback_waits_on_the_outputs_device():
    """Outputs on the last card, computed behind ~0.5 s of work there, read
    back while cuda:0 is the current device: `_rp_wait` returns them whole
    (an event recorded on cuda:0's idle stream would return at once, before
    the copy ran). The chain runs once first, so that its second launch is
    not slowed to the card's pace by first-use loading; the readback's
    pinned block is cached beforehand and holds NaN, as a fresh
    ``cudaHostAlloc`` could wait for the card and hide the fault."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the outputs must lie on a device other than "
                    "the current one")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    owner = types.SimpleNamespace(replay_counts=dict(readbacks=0))
    _chain(dev)
    torch.cuda.synchronize(dev)
    stale = torch.full((16, 48), float("nan"), pin_memory=True)
    del stale  # the caching host allocator keeps the block for the readback
    with torch.cuda.device(0):
        outs = _chain(dev)
        got = LviSystem._rp_wait(LviSystem._rp_readback(owner, outs))
        want = outs.cpu().numpy()
    assert owner.replay_counts["readbacks"] == 1
    assert (got == want).all()
