"""The port's YAML reader and writer (``patch_toon_tpu_torch/config/
yamlio.py``) against PyYAML.

``yamlio.load`` must return what ``yaml.safe_load`` returns on every file
of ``config/``, on the JAX package's run snapshot
``docs/train_soak/run/config.yaml`` and on the dotlist override values of
``tests/test_torch_cli.py``; ``yamlio.dump`` must give the bytes of
``yaml.safe_dump(tree, sort_keys=False)`` on the composed trees, on a tree
with paths and strings longer than the 80-column fold, and on the
snapshot, whose own bytes it reproduces. A ``hypothesis`` search holds
``load(dump(t)) == t`` (and dump's bytes PyYAML's) over trees of dicts,
lists and scalars with printable ASCII strings. Each construct the reader
does not take raises ValueError naming it and its line.
"""

import pathlib

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from patch_toon_tpu_torch.config import yamlio
from patch_toon_tpu_torch.config.compose import compose, to_container

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "config"
SNAPSHOT = REPO / "docs" / "train_soak" / "run" / "config.yaml"
FILES = sorted(CONFIG.rglob("*.yaml")) + [SNAPSHOT]

# the override values of tests/test_torch_cli.py's OVERRIDES, and the
# scalar forms whose type PyYAML's YAML 1.1 resolver decides
VALUES = ["/data/run/last.ckpt", "/data/in", "{}", "32_fast", "false",
          "0.1", "5", "2.5", "[4,8,8,8,8,4]", "null", "'%04d'", "25",
          "{a: 1, b: x}", "yes", "16", "off", "Off", "on", "1e-5", "1.0e-05",
          "0.00001", "~", "NULL", "1_000", "${now:%Y-%m-%d}",
          "${training.output_dir}/${now:%H-%M-%S}", "'off'", '"a\\tb"',
          ".inf", "-.Inf", ".nan", "0x1f", "017", "0b101", "1:30",
          "+12", "-0", ".5", "[0.9, 0.999]",
          "{temporal: {path: /s/temporal, depth: 3}}",
          "{point_vector: {path: [/a/tracking,/b/tracking], depth: 3}}",
          "[/a/input,/b/input,/c/input]", "a b  c # note", "x:y", "[a:b]",
          "it's", "'it''s'", "- a\n- b", "a: 1\nb: [2, {c: d}]",
          "'folded\n  quoted'", "plain\n  folded\n\n  twice"]


def _same(a, b) -> bool:
    return repr(a) == repr(b) and type(a) is type(b)


@pytest.mark.parametrize(
    "text", [f.read_text() for f in FILES] + VALUES,
    ids=[str(f.relative_to(REPO)) for f in FILES] + VALUES)
def test_load_equals_safe_load(text):
    assert _same(yamlio.load(text), yaml.safe_load(text))


LONG_PATH = "/srv/" + "/".join(["shot_0042_comp_v003"] * 6)
NOTE = ("a note that runs past the eightieth column, so PyYAML folds it "
        "at a space; ") * 3


def _trees():
    long_path = LONG_PATH
    return {
        "train": to_container(compose(CONFIG, "config", overrides=[
            "run.dir=/tmp/run"])),
        "inference": to_container(compose(CONFIG, "inference")),
        "long": to_container(compose(CONFIG, "config", overrides=[
            f"run.dir={long_path}", f"data.dir_pre={long_path}/input",
            f"+training.note={NOTE}",
            "+training.quoted='off: " + "a quoted value " * 8 + "'",
            f"data.dir_post=[{long_path}/a,{long_path}/b]"])),
        "snapshot": yaml.safe_load(SNAPSHOT.read_text()),
    }


@pytest.mark.parametrize("name", ["train", "inference", "long", "snapshot"])
def test_dump_gives_safe_dump_bytes(name):
    tree = _trees()[name]
    text = yamlio.dump(tree)
    assert text == yaml.safe_dump(tree, sort_keys=False)
    assert yamlio.load(text) == tree
    if name == "snapshot":
        assert text == SNAPSHOT.read_text()
    if name == "long":  # a path has no space to fold at; the note folds
        assert f"  dir: {LONG_PATH}\n" in text
        assert f"note: {NOTE.strip()}" not in text
        assert max(map(len, text.splitlines())) > 80


_TEXT = st.text(st.characters(min_codepoint=32, max_codepoint=126),
                max_size=120)
_KEY = st.text(st.characters(min_codepoint=32, max_codepoint=126),
               min_size=1, max_size=60)
_SCALAR = (st.none() | st.booleans() | st.integers()
           | st.floats(allow_nan=False) | _TEXT)
_TREE = st.dictionaries(_KEY, st.recursive(
    _SCALAR, lambda c: st.lists(c, max_size=4)
    | st.dictionaries(_KEY, c, max_size=4), max_leaves=20), max_size=5)


@settings(max_examples=400, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_TREE)
def test_dump_round_trip(tree):
    text = yamlio.dump(tree)
    assert text == yaml.safe_dump(tree, sort_keys=False)
    assert yamlio.load(text) == tree


@pytest.mark.parametrize("text, what", [
    ("a: &x 1\nb: 2", "anchor"), ("a: *x", "alias"),
    ("a: !!str 1", "tag"), ("a: |\n  text", "block scalar"),
    ("a: >\n  text", "block scalar"), ("---\na: 1\n---\nb: 2", "second "
                                       "document"),
    ("%YAML 1.1\n---\na: 1", "directive"), ("? a\n: 1", "complex key"),
    ("a:\n\tb: 1", "tab"), ("day: 2024-01-31", "timestamp"),
    ("<<: {a: 1}", "merge"), (": 1", "empty mapping key"),
    ("[a]: 1", "collection as a mapping key"),
])
def test_unsupported_constructs_raise(text, what):
    with pytest.raises(ValueError, match=what) as err:
        yamlio.load(text)
    assert "line" in str(err.value)


@pytest.mark.parametrize("tree", [
    {"a": "é"}, {"a": "two\nlines"}, {"": 1}, {"k" * 130: 1},
    {"a": [1], "b": None}, {(1, 2): 3}])
def test_dump_refuses_what_it_cannot_write_as_pyyaml(tree):
    if tree.get("b", 0) is None:  # one list reached twice: an anchor
        tree["b"] = tree["a"]
    with pytest.raises(ValueError):
        yamlio.dump(tree)
