"""The dependency-free scenario YAML loader (grammar/yamlsubset.py) against
PyYAML, on every scenario document the tests hold, and the grammar's
import path without PyYAML."""

import ast
import pathlib
import subprocess
import sys

import pytest
import yaml

from varlociraptor_tpu.grammar.yamlsubset import YamlSubsetError, load

TESTS = pathlib.Path(__file__).parent


def _yaml_scenarios():
    """String literals the tests parse as scenario YAML."""
    docs = []
    for path in sorted(TESTS.glob("test_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and "\n" in node.value
                and ("samples:" in node.value or "events:" in node.value)
            ):
                docs.append(pytest.param(node.value, id=f"{path.stem}:{node.lineno}"))
    return docs


def _dict_scenarios():
    """Scenarios the tests build as dicts, dumped by PyYAML in block and
    flow style."""
    import test_burden_scatter
    import test_missing_data
    import test_scope_lifts

    found = {
        "burden": test_burden_scatter.SCENARIO,
        "missing": test_missing_data.SCENARIO,
        "trio": test_scope_lifts.TRIO_SCENARIO,
        "contam_trio": test_scope_lifts.CONTAM_TRIO_SCENARIO,
    }
    return [
        (f"{name}-{style}", yaml.safe_dump(doc, default_flow_style=flow))
        for name, doc in found.items()
        for style, flow in (("block", False), ("flow", None))
    ]


HANDWRITTEN = """\
# tumor-normal with the features scenario files use
species:
  heterozygosity: 0.001      # plain float
  germline-mutation-rate: 1e-3
  genome-size: 3.5e9
  ploidy:
    male: {all: 2, X: 1, Y: 1}
    female: {all: 2, X: 2, Y: 0}
samples:
  'tumor':
    sex: female
    universe: "[0.0,0.25[ | [0.25,1.0]"
    contamination: {by: normal, fraction: 0.25}
    somatic-effective-mutation-rate: 1e-06
  normal:
    resolution: 100
    inheritance: ~
events:
  somatic_tumor: "tumor:]0.0,1.0] & normal:0.0"
  germline: normal:0.5 | normal:1.0   # unquoted, colons without space
  absent: 'tumor:0.0 & normal:0.0'
"""

MORE_SYNTAX = """\
flags: [a, 'b c', "d#e", 2, 0.5, -3, 0x1f, .inf, yes, off]
nested: {a: [1, {b: c}], 'd e': null}
multi: [x,
  y]
list:
  - one
  - two: 2
    three: [3]
  -
    - deep
quote: 'it''s'
escape: "a\\tb"
"""


@pytest.mark.parametrize("doc", _yaml_scenarios())
def test_loader_matches_pyyaml_on_test_documents(doc):
    assert load(doc) == yaml.safe_load(doc)


@pytest.mark.parametrize("name,doc", _dict_scenarios())
def test_loader_matches_pyyaml_on_dumped_scenarios(name, doc):
    assert load(doc) == yaml.safe_load(doc)


@pytest.mark.parametrize("doc", [HANDWRITTEN, MORE_SYNTAX])
def test_loader_matches_pyyaml_on_handwritten_documents(doc):
    assert load(doc) == yaml.safe_load(doc)


@pytest.mark.parametrize("doc", ["a: &x 1\nb: *x\n", "a: |\n  text\n", "a:\n\tb: 1\n"])
def test_loader_refuses_unsupported_constructs(doc):
    with pytest.raises(YamlSubsetError):
        load(doc)


def test_grammar_imports_and_parses_without_pyyaml():
    """The generic call path (grammar/scenario.py) needs no PyYAML."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from varlociraptor_tpu.grammar.scenario import Scenario\n"
        f"sc = Scenario.from_yaml({HANDWRITTEN!r})\n"
        "assert sc.sample_names == ['normal', 'tumor'], sc.sample_names\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=TESTS.parent, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
