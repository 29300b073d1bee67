"""The port's vocabulary trainer (``lvislam_tpu_torch.scripts.train_vocab``)
against ``scripts/train_vocab.py`` on JAX at toy arguments (one world, three
frames, 64 words): the same keypoint validity and descriptors, the same
words and idf, the same file."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from lvislam_tpu_torch.scripts import train_vocab  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from test_torch_rosbag_entry import load_script  # noqa: E402

torch.set_num_threads(1)

TOY = ["--worlds", "1", "--frames", "3", "--words", "64"]


@pytest.fixture(scope="module")
def jax_script():
    return load_script("train_vocab")


def test_harvest_equals_jax(jax_script):
    """`harvest` over world 0 on its circle at the script's frame times:
    the validity and the descriptors equal JAX's."""
    from lvislam_tpu.utils import synthetic as jsyn

    times = np.linspace(0.5, 20.0, 3)
    jd, jv = jax_script.harvest(jsyn.default_world(seed=0),
                                jsyn.circle_trajectory(radius=3.0, period=20.0), times, 320, 240)
    td, tv = train_vocab.harvest(tsyn.default_world(seed=0),
                                 tsyn.circle_trajectory(radius=3.0, period=20.0), times, 320, 240,
                                 device="cpu")
    assert len(td) == len(jd) == 3
    for a, b, va, vb in zip(td, jd, tv, jv):
        np.testing.assert_array_equal(va, np.asarray(vb))
        assert va.sum() > 20
        np.testing.assert_array_equal(a, np.asarray(b))


def test_main_equals_jax(jax_script, tmp_path, monkeypatch):
    """The whole script at toy arguments: the returned words and idf, and
    the written files, equal the JAX script's."""
    out = tmp_path / "port.npz"
    vocab, idf = train_vocab.main([str(out), *TOY, "--device", "cpu"])
    ref = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", ["train_vocab.py", str(ref), *TOY])
    jax_script.main()
    a, b = np.load(out), np.load(ref)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    from lvislam_tpu_torch.ops import brief

    v2, i2 = brief.load_vocabulary(str(ref))
    assert vocab.shape == (64, brief.N_BITS)
    np.testing.assert_array_equal(vocab, v2)
    np.testing.assert_array_equal(idf, i2)


def test_without_a_card_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocab.main([str(tmp_path / "v.npz"), *TOY])
