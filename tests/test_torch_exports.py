"""The port's public names: every name that the JAX package's `__init__`,
`ops/__init__` and `utils/__init__` export can be imported from the port's
counterpart, and is the port's own object (a class, a function or the
version string), not a JAX one."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _exported(module: str) -> list:
    """The names a JAX package `__init__` binds (imports and assignments)."""
    path = ROOT / "naturalspeech2_tpu" / Path(*module.split(".")[1:]) / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


CASES = [(m, name) for m in ("naturalspeech2_tpu", "naturalspeech2_tpu.ops",
                             "naturalspeech2_tpu.utils") for name in _exported(m)]


def test_the_lists_are_whole():
    counts = {m: len(_exported(m)) for m in ("naturalspeech2_tpu", "naturalspeech2_tpu.ops",
                                             "naturalspeech2_tpu.utils")}
    assert counts == {"naturalspeech2_tpu": 29, "naturalspeech2_tpu.ops": 6,
                      "naturalspeech2_tpu.utils": 13}


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}.{n}" for m, n in CASES])
def test_name_is_exported_by_the_port(module, name):
    port = importlib.import_module(module.replace("naturalspeech2_tpu", "naturalspeech2_tpu_torch",
                                                  1))
    obj = getattr(port, name)
    if name == "__version__":
        assert obj == importlib.import_module("naturalspeech2_tpu").__version__
        return
    assert obj.__module__.startswith("naturalspeech2_tpu_torch"), obj.__module__


def test_helpers_behave():
    import torch

    from naturalspeech2_tpu_torch.utils import (default, divisible_by, exists, identity,
                                                lengths_from_mask, right_pad_dims_to)

    assert exists(0) and not exists(None)
    assert default(None, lambda: 3) == 3 and default(None, 4) == 4 and default(5, 4) == 5
    assert divisible_by(9, 3) and not divisible_by(9, 2)
    assert identity("x", 1, k=2) == "x"
    mask = torch.tensor([[True, True, False], [False, False, False]])
    assert lengths_from_mask(mask).tolist() == [2, 0]
    x, t = torch.zeros(2, 3, 4), torch.arange(2.0)
    assert right_pad_dims_to(x, t).shape == (2, 1, 1)
    assert right_pad_dims_to(t, x) is x
