"""``tests/unit/test_completeness.py``'s two meta-tests over the port:
every model module of ``pysdm_tpu_torch/models`` and every dynamic that
``pysdm_tpu_torch.dynamics`` exports is named by at least one of the
port's test files (``tests/*/test_torch_*.py``), and the port exports
every dynamic the JAX package does."""

import pathlib
import re

REPO = pathlib.Path(__file__).resolve().parents[2]
MODELS = REPO / "pysdm_tpu_torch" / "models"
TESTS = pathlib.Path(__file__).resolve().parents[1]


def _port_test_text():
    return "\n".join(
        p.read_text() for p in TESTS.rglob("test_torch_*.py")
        if p.name != pathlib.Path(__file__).name
    )


def _dynamics(module):
    return {name for name in dir(module) if re.match(r"^[A-Z]", name)}


def test_every_model_module_has_a_test():
    tests_text = _port_test_text()
    names = [m.stem for m in sorted(MODELS.glob("*.py")) if m.stem != "__init__"]
    assert names
    missing = [name for name in names if name not in tests_text]
    assert not missing, f"model modules with no test reference: {missing}"


def test_every_dynamic_has_a_test():
    import pysdm_tpu.dynamics
    import pysdm_tpu_torch.dynamics

    tests_text = _port_test_text()
    names = _dynamics(pysdm_tpu_torch.dynamics)
    assert names >= _dynamics(pysdm_tpu.dynamics)
    missing = sorted(name for name in names if name not in tests_text)
    assert not missing, f"dynamics with no test reference: {missing}"
