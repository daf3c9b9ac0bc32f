"""The port's packages export what the reference's packages export.

Every public name a reference package's ``__init__.py`` binds (an import,
a definition or an assignment) must be bound by the port's package of the
same name and resolve on import, unless it is listed below with the
ROADMAP item that ports it, or with the port's name for a TPU-only one.
A listed name that the port has since bound fails the test, so the list
only shrinks.  The packages are read with ``ast``, so neither JAX nor
torch is imported to list them.
"""
import ast
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

# reference package -> {name: why the port does not bind it yet}
NOT_YET = {
    "kernels": {
        "on_tpu": "TPU-only; the port's dispatch is ops.on_cuda",
        "swap_best_pallas": "TPU kernel; the port's is bfio_swap.swap_best",
        "swap_best_xla": "the port's plain version is swap_best_plain",
        "paged_decode_attention_pallas":
            "TPU kernel; the port's is paged_decode_attention",
        # the port's package binds these names to the submodules that hold
        # each wrapper; the calls are ops.<name>
        "decode_attention": "submodule; the call is ops.decode_attention",
        "rms_norm": "submodule; the call is ops.rms_norm",
        "ssm_chunk_scan": "the call is ops.ssm_chunk_scan",
        "swap_best": "the call is ops.swap_best",
    },
    "launch": dict.fromkeys(
        ["ShardingRules", "activation_spec", "batch_axes_for",
         "batch_shardings", "cache_shardings", "make_cpu_mesh",
         "make_production_mesh", "param_shardings"],
        "ROADMAP Queue A item 12 (mesh and launch tools)"),
}
# packages the port does not mirror: the analysis passes scan the port
# from the reference package (ROADMAP, Port rules)
NOT_PORTED = {"analysis"}


def _bound(init: Path) -> set:
    """Public names bound at the top level of a package's __init__.py."""
    out = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_") and n != "annotations"}


PACKAGES = sorted(p.parent.name for p in (SRC / "repro").glob("*/__init__.py")
                  if p.parent.name not in NOT_PORTED)


def test_every_reference_package_is_listed():
    assert {"core", "serving", "training"} <= set(PACKAGES)
    assert set(NOT_YET) <= set(PACKAGES)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_exports_reference_names(pkg):
    want = _bound(SRC / "repro" / pkg / "__init__.py")
    init = SRC / "repro_torch" / pkg / "__init__.py"
    got = _bound(init) if init.exists() else set()
    listed = NOT_YET.get(pkg, {})
    assert not set(listed) - want, "listed names the reference lacks"
    assert not set(listed) & got, (
        f"repro_torch.{pkg} now binds {sorted(set(listed) & got)}: take "
        "them off the list")
    assert sorted(want - got - set(listed)) == []
    if init.exists():
        mod = importlib.import_module(f"repro_torch.{pkg}")
        for name in want - set(listed):
            assert hasattr(mod, name), f"repro_torch.{pkg}.{name}"
