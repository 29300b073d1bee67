"""The port's configuration tree (``lvislam_tpu_torch.core.config``) and its
YAML-subset reader (``core/yamlite.py``) against PyYAML and the JAX
package's ``lvislam_tpu.core.config``: exact equality throughout (the
reader must give ``yaml.safe_load``'s values, the configuration JAX's
fields)."""

import dataclasses
import os

import pytest
import torch
import yaml

from lvislam_tpu.core import config as jconfig
from lvislam_tpu_torch.core import config as tconfig
from lvislam_tpu_torch.core import yamlite
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LIDAR = {"shipped": os.path.join(ROOT, "configs", "params_lidar.yaml"),
         "fixture": os.path.join(ROOT, "tests", "data", "fixture_lidar.yaml")}
CAMERA = {"shipped": os.path.join(ROOT, "configs", "params_camera.yaml"),
          "fixture": os.path.join(ROOT, "tests", "data", "fixture_camera.yaml")}
FILES = {f"{k}_lidar": v for k, v in LIDAR.items()} | {f"{k}_camera": v for k, v in CAMERA.items()}


def pyyaml(text: str):
    """PyYAML on the text as the JAX loader feeds it (OpenCV header and
    matrix tags stripped)."""
    return yaml.safe_load(text.replace("%YAML:1.0", "").replace("!!opencv-matrix", ""))


@pytest.mark.parametrize("name", sorted(FILES))
def test_reader_equals_pyyaml_on_the_repo_files(name):
    with open(FILES[name]) as f:
        text = f.read()
    got = yamlite.loads(text)
    assert got == pyyaml(text)
    assert yamlite.load(FILES[name]) == got


CASES = {
    "flow_list_over_lines": "m:\n  data: [-0.06, 0.1,\n         2.5e-03, # a comment\n         -1,]\n",
    "comments": "# head\na: 1  # after an int\n\nb: text # after a string\n  # indented\nc: 'x # y'\n",
    "opencv_header_and_tag": "%YAML:1.0\n---\nR: !!opencv-matrix\n  rows: 1\n  cols: 2\n  dt: d\n"
                             "  data: [1.0, 0.0]\n",
    "ros2_nesting": "/**:\n  ros__parameters:\n    N_SCAN: 4\n    sensor: livox\n"
                    "    dir: \"/tmp/maps/\"\n",
    "scalars": "a: 3.99e-03\nb: 1e-3\nc: .5\nd: -7\ne: +3\nf: true\ng: Off\nh: ~\ni: null\n"
               "j: 1_000\nk: -.inf\nl: 1.\nm: 0\nn: \"q\\\"uote\"\no: 'it''s'\np:\nq: []\n",
    "nested_and_dedent": "a:\n  b:\n    c: 1\n  d: [x, y]\ne: 2\n",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_equals_pyyaml_on_cases(case):
    assert yamlite.loads(CASES[case]) == pyyaml(CASES[case])


UNSUPPORTED = {
    "block_sequence": ("a:\n  - 1\n  - 2\n", 2),
    "anchor": ("a: &x 1\n", 1),
    "alias": ("a: 1\nb: *x\n", 2),
    "second_document": ("a: 1\n---\nb: 2\n", 2),
    "block_scalar": ("a: |\n  text\n", 1),
    "flow_mapping": ("a: {b: 1}\n", 1),
    "nested_flow": ("a: [[1, 2]]\n", 1),
    "other_tag": ("a: !!str 1\n", 1),
    "octal": ("a: 010\n", 1),
    "hex": ("a: 0x1F\n", 1),
    "continued_scalar": ("a: one\n  two\n", 2),
    "mapping_in_scalar": ("a: b: c\n", 1),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "unterminated_flow": ("a: [1, 2\n", 1),
    "directive": ("%TAG ! tag:x\na: 1\n", 1),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_reader_raises_outside_its_subset(case):
    text, line = UNSUPPORTED[case]
    with pytest.raises(ValueError, match=f"line {line}:"):
        yamlite.loads(text)


def test_reader_empty_document():
    assert yamlite.loads("# only a comment\n\n") is None


COMBOS = [(lid, cam) for lid in (None, "shipped", "fixture") for cam in (None, "shipped", "fixture")]


@pytest.mark.parametrize("lid,cam", COMBOS, ids=[f"{a}-{b}" for a, b in COMBOS])
def test_load_yaml_equals_jax(lid, cam):
    paths = (LIDAR.get(lid), CAMERA.get(cam))
    got = tconfig.load_yaml(*paths)
    want = jconfig.load_yaml(*paths)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == convert.system_config_from_jax(want)
    hash(got)


def test_shipped_yamls_are_the_defaults():
    """As `tests/test_config.py` for JAX: `configs/` reproduces the
    dataclass defaults."""
    assert tconfig.load_yaml(LIDAR["shipped"], CAMERA["shipped"]) == tconfig.SystemConfig()


def test_default_config_and_min_parallax_equal_jax():
    got, want = tconfig.default_config(), jconfig.default_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == convert.system_config_from_jax(want)
    for cfg in (got, tconfig.load_yaml(None, CAMERA["fixture"])):
        jv = jconfig.VinsConfig(**{f.name: getattr(cfg.vins, f.name)
                                   for f in dataclasses.fields(cfg.vins) if f.name != "camera"})
        assert tconfig.min_parallax(cfg.vins) == jconfig.min_parallax(jv)
    hash(got.lidar), hash(got.vins), hash(got.caps), hash(got)


def test_system_config_replace_and_frozen():
    cfg = tconfig.default_config()
    lid = dataclasses.replace(cfg.lidar, N_SCAN=16)
    new = cfg.replace(lidar=lid)
    assert new.lidar.N_SCAN == 16 and cfg.lidar.N_SCAN == 4
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.lidar.N_SCAN = 8


def test_filter_fields_equals_jax():
    raw = {"N_SCAN": 8, "extrinsicTrans": [1.0, 2.0, 3.0], "unknown": 5}
    assert tconfig._filter_fields(tconfig.LidarConfig, raw) == \
        jconfig._filter_fields(jconfig.LidarConfig, raw)
