"""The port's config YAML (witw_tpu_torch.configs.serialize) against
witw_tpu's (witw_tpu/configs/serialize.py, on PyYAML), on the CPU.

Each direction: a file that one package's ``save_config`` writes loads in
the other's ``load_config`` as the same config (the port's configs are held
equal to witw_tpu's field by field through ``config_to_dict``). For the
presets the port writes PyYAML's text byte for byte; its reader and writer
also agree with PyYAML on scalars that need quoting and nested mappings.
The reader refuses what it does not read, PyYAML's folding of long strings
and the plain forms that YAML 1.1 reads as other types included.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import dataclasses
import math

import pytest
import yaml

import witw_tpu.configs as jcfg
import witw_tpu_torch.configs as tcfg
from witw_tpu.configs import serialize as jser
from witw_tpu_torch.configs import serialize as tser

PRESETS = {
    "fov": lambda m: m.fov_experiment("cvusa", 360),
    "semantic": lambda m: m.semantic_experiment("witw", 90),
    "safa": lambda m: m.safa_experiment("witw", 70),
    "baseline": lambda m: m.baseline_experiment("witw"),
}


def _edited(m, name):
    """A preset with fields away from their defaults: the semantic
    5-channel config with a train override, or a baseline config with
    orientation maps and a float exponent."""
    cfg = PRESETS[name](m)
    if name == "semantic":
        assert cfg.model.in_channels == 5 and cfg.data.channels == 5
        return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=7, async_checkpoints=True,
                                                     checkpoint_dir="./runs dir/it's here"))
    return cfg.replace(model=dataclasses.replace(cfg.model, orientation_maps=True, gem_power=2.5,
                                                 conv_precision="highest"),
                       eval=dataclasses.replace(cfg.eval, topk=(1, 2, 3, 50)))


def _cases():
    return [(name, False) for name in PRESETS] + [("semantic", True), ("baseline", True)]


@pytest.mark.parametrize("name,edited", _cases())
def test_port_reads_witw_tpu_yaml(tmp_path, name, edited):
    jc = _edited(jcfg, name) if edited else PRESETS[name](jcfg)
    tc = _edited(tcfg, name) if edited else PRESETS[name](tcfg)
    path = tmp_path / "cfg.yaml"
    jser.save_config(jc, str(path))
    got = tser.load_config(str(path))
    assert got == tc
    assert tser.config_to_dict(got) == jser.config_to_dict(jc)


@pytest.mark.parametrize("name,edited", _cases())
def test_witw_tpu_reads_port_yaml(tmp_path, name, edited):
    jc = _edited(jcfg, name) if edited else PRESETS[name](jcfg)
    tc = _edited(tcfg, name) if edited else PRESETS[name](tcfg)
    path = tmp_path / "cfg.yaml"
    tser.save_config(tc, str(path))
    assert jser.load_config(str(path)) == jc
    assert tser.load_config(str(path)) == tc
    assert path.read_text() == yaml.safe_dump(jser.config_to_dict(jc), sort_keys=False)


TREES = [
    {"a": {"x": 1, "y": [1, 2], "z": {"deep": [3.5, "four"]}}, "b": {}, "c": []},
    {"strings": ["yes", "No", "null", "~", "", "1.0", "0x1F", "017", "1_000", ".inf", "-x", "#c",
                 "a: b", "a #b", " lead", "trail ", "it's", "'q'", '"d"', "x\ny\t\u00e9\x07",
                 "[1]", "{a}", "&a", "*a", "!t", "|", ">", "%", "@x", "`x", "./data/x-19.csv",
                 "a" * 120, "\u00e9t\u00e9", "0o17", "1e5", "3rd", "yEs"]},
    {"floats": [0.1, -0.0, 1e16, 1e-05, 2.5e-300, math.inf, -math.inf, 123456789.0],
     "ints": [0, -7, 2 ** 40], "bools": [True, False], "none": None},
    {"top": ["level", 1], "x": {"y": {"z": []}}},
]
LONG = ["a" * 120 + " b" * 60, "x " * 50 + "'q: r'" * 20, "\u00e9" * 30]


@pytest.mark.parametrize("tree", TREES)
def test_yaml_subset_agrees_with_pyyaml(tree):
    """The port's writer: PyYAML reads its text as the tree. The port's
    reader: it reads the port's text and PyYAML's (with its quoting) as
    PyYAML does."""
    text = tser.dump_yaml(tree)
    assert yaml.safe_load(text) == tree
    assert tser.load_yaml(text) == tree
    theirs = yaml.safe_dump(tree, sort_keys=False)
    assert tser.load_yaml(theirs) == yaml.safe_load(theirs) == tree


@pytest.mark.parametrize("text", LONG, ids=["plain", "single-quoted", "double-quoted"])
def test_yaml_reader_refuses_pyyaml_folded_strings(text):
    """PyYAML folds a long string over several lines; the port refuses that
    file, and writes the string on one line, which both read back."""
    with pytest.raises(ValueError, match="several lines"):
        tser.load_yaml(yaml.safe_dump({"a": text}, sort_keys=False))
    ours = tser.dump_yaml({"a": text})
    assert ours.count("\n") == 1
    assert tser.load_yaml(ours) == yaml.safe_load(ours) == {"a": text}


def test_yaml_reader_resolves_plain_scalars_as_pyyaml():
    text = ("e: .5\nf: -.inf\nh: 1.5e+3\ni: True\nj: FALSE\nk: ~\nl:\nm: +3\no: -0\n"
            "p: plain text  # a comment\nq: 'x' # another\n# whole-line comment\nr: 1.\n"
            "s: ./data/x-19.csv\nt: NULL\nu: '017'\nv: 0o17\nw: 1e5\nx: 3rd\ny: 2024-01-05x\n"
            "z1: 09\nz2: +.5\nz3: 2024-1-5\n")
    assert tser.load_yaml(text) == yaml.safe_load(text)
    assert math.isnan(tser.load_yaml("x: .NaN\n")["x"])
    for plain in ("017", "0x1F", "1_000", "1_0.5", "Yes", "OFF", "0b101", "1:30", "-1:30.5",
                  "2024-01-05", "2024-1-5 10:20:30 +1", "<<", "="):
        with pytest.raises(ValueError, match="quote it"):  # YAML 1.1 reads other types
            tser.load_yaml(f"a: {plain}\n")


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a: &x 1\n", "a: |\n  b\n", "a:\n\tb: 1\n",
                                  "a: 'open\n", "a: 1\n  b: 2\n", "a: 1\na: 2\n",
                                  "a:\n- b: 1\n", "a:\n- - 1\n", "---\na: 1\n", "'a': 1\n",
                                  "a: 'two\n  lines'\n", "a: \"\\q\"\n", "- 1\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """Flow collections, anchors, block scalars, tabs, open quotes, keys in
    a scalar, repeated keys, lists of anything but scalars, document
    markers, quoted keys, multi-line scalars, escapes PyYAML does not write,
    and a document that is not a mapping."""
    with pytest.raises(ValueError):
        tser.load_yaml(text)
    with pytest.raises(TypeError):
        tser.dump_yaml({"a": [{"b": 1}]})
