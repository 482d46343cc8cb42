"""Name by name, the port has everything the reference has.

For every module of ``seaweedfs_tpu``, each public top-level name (a
function, a class or a module-level assignment not starting with ``_``)
and each public method of each public class must exist in the module at
the same relative path of ``seaweedfs_tpu_torch``. Both packages are
read as source with ``ast``; neither is imported.

``RENAMED`` is the one table of exceptions: the JAX-side names that the
port does in its own idiom, each mapped to its counterpart, which must
exist. A module the port has no file for maps as a whole.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "seaweedfs_tpu")
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")

# reference "module:name" (or a module) -> port "module:name" (or a module)
RENAMED = {
    "ops/pallas/__init__.py": "ops/kernels/__init__.py",
    "ops/pallas/gf_kernel.py": "ops/kernels/gf_kernel.py",
    "ops/pallas/gf_kernel.py:gf_matmul_pallas":
        "ops/kernels/gf_kernel.py:gf_matmul_fused",
    "ops/pallas/gf_kernel.py:gf_matmul_swar": "ops/kernels/gf_swar.py:gf_matmul",
    "ops/pallas/gf_kernel.py:gf_matmul_swar_device":
        "ops/kernels/gf_swar.py:gf_matmul",
    # the Pallas tiles: the repack route's tile, and the launch geometry
    # the CUDA kernels choose per launch
    "ops/pallas/gf_kernel.py:DEFAULT_TILE_N":
        "ops/kernels/gf_repack.py:DEFAULT_TILE_N",
    "ops/pallas/gf_kernel.py:VPU_MAX_TILE_N": "ops/kernels/gf_vpu.py:KERNEL",
    "ops/pallas/gf_kernel.py:SWAR_DEFAULT_TILE4":
        "ops/kernels/gf_swar.py:launch_plan",
    "ops/gf_matmul.py:gf_matmul_xla": "ops/gf_matmul.py:gf_matmul_bits",
    "ops/profiler.py:annotate_jax": "ops/profiler.py:annotate",
    "telemetry/snapshot.py:jax_backend": "telemetry/snapshot.py:backend",
}


def public_names(path: str) -> set[str]:
    """Public top-level names of a module, and ``Class.method`` for each
    public method of each public class."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(
                f"{node.name}.{m.name}" for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not m.name.startswith("_")
            )
        elif isinstance(node, ast.Assign):
            out.update(e.id for t in node.targets for e in ast.walk(t)
                       if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def reference_modules() -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(root, n), REF)
        for root, _, names in os.walk(REF) for n in names
        if n.endswith(".py")
    )


def port_has(target: str) -> bool:
    module, _, name = target.partition(":")
    path = os.path.join(PORT, module)
    return os.path.exists(path) and (not name or name in public_names(path))


@pytest.mark.parametrize("module", reference_modules())
def test_every_public_name_has_its_port(module):
    names = public_names(os.path.join(REF, module))
    port_module = RENAMED.get(module, module)
    assert port_has(port_module), f"no port of {module}"
    ported = public_names(os.path.join(PORT, port_module))
    missing = []
    for name in sorted(names):
        renamed = RENAMED.get(f"{module}:{name}")
        if renamed is not None:
            assert port_has(renamed), f"{module}:{name} -> {renamed}"
        elif name not in ported:
            missing.append(name)
    assert not missing, f"{module}: the port lacks {missing}"


def test_renamed_table_holds_only_renames():
    """Each entry names something the reference has and the port lacks
    under that name, and its counterpart exists."""
    for ref, port in RENAMED.items():
        module, _, name = ref.partition(":")
        path = os.path.join(REF, module)
        assert os.path.exists(path), ref
        assert not name or name in public_names(path), ref
        assert not port_has(ref), f"{ref} is not renamed"
        assert port_has(port), f"{ref} -> {port}"
