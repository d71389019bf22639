"""The list of tests that the root ``conftest.py`` marks ``slow`` (left out of
tier-1) names real tests, and none of the port's."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _slow_tests():
    tree = ast.parse((REPO / "conftest.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == ["SLOW_TESTS"]:
            return ast.literal_eval(node.value)
    raise AssertionError("conftest.py has no SLOW_TESTS")


def test_each_slow_test_is_a_module_level_def():
    for nodeid in _slow_tests():
        path, name = nodeid.split("::")
        tree = ast.parse((REPO / path).read_text())
        defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert name in defs, f"{nodeid}: no module-level def {name} in {path}"


def test_no_port_test_is_slow():
    port = [n for n in _slow_tests() if Path(n.split("::")[0]).name.startswith("test_torch_")]
    assert not port, f"port tests are repaired in their own files, never left out of tier-1: {port}"
