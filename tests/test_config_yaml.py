"""The in-repo YAML loader (``config.parse_yaml``) against PyYAML on every
shipped config, and on the subset's edge cases against fixed values."""

from pathlib import Path

import pytest

from fetalsyngen_tpu.config import YAMLSubsetError, load_yaml, parse_yaml

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


def test_every_config_is_covered():
    assert len(CONFIGS) == 6, CONFIGS


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_matches_pyyaml(rel):
    yaml = pytest.importorskip("yaml")
    text = (REPO / rel).read_text()
    assert parse_yaml(text) == yaml.safe_load(text)


EDGE_CASES = [
    ("flow lists", 'a: [1, [2, 3], "b, c", d]\ne: []',
     {"a": [1, [2, 3], "b, c", "d"], "e": []}),
    ("comments", 'a: 1  # note\n# whole line\nb: "x # kept"\nc: x#y\nd: \'p # q\' # r',
     {"a": 1, "b": "x # kept", "c": "x#y", "d": "p # q"}),
    ("interpolations", 'size: ${..shape}\ndevice: "${..device}"',
     {"size": "${..shape}", "device": "${..device}"}),
    ("scalars", "i: -3\nf: 0.5\ng: .5\nh: 1e3\nb: true\nn: null\nt: ~\ne:\ns: 'it''s'",
     {"i": -3, "f": 0.5, "g": 0.5, "h": "1e3", "b": True, "n": None, "t": None,
      "e": None, "s": "it's"}),
    ("sequence of mappings", "x:\n  - a: 1\n    b: [2]\n  -\n    - 3\ny:\n- z",
     {"x": [{"a": 1, "b": [2]}, [3]], "y": ["z"]}),
    ("flow mapping", "m: {k: 1, l: [a, b]}", {"m": {"k": 1, "l": ["a", "b"]}}),
]


@pytest.mark.parametrize("name,text,want", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_yaml_subset_edge_cases(name, text, want):
    assert parse_yaml(text) == want


@pytest.mark.parametrize("text", ["a: &x 1", "a: |\n  text", "a:\n\tb: 1", "a: [1, 2"])
def test_yaml_outside_subset_raises(text):
    with pytest.raises(YAMLSubsetError):
        parse_yaml(text)


def test_load_yaml_composes_defaults():
    cfg = load_yaml(REPO / "configs" / "dataset" / "synth_train.yaml")
    assert cfg["generator"]["shape"] == [256, 256, 256]
    assert cfg["generator"]["spatial_deform"]["size"] == "${..shape}"
    assert cfg["_target_"].endswith("FetalSynthDataset")
