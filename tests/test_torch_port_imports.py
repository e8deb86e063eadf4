"""The port stands alone: it imports torch, never jax or the JAX package;
importing it loads no h5py either (only the ModelNet .h5 reader needs it)."""
import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "ogmm_tpu_torch"
MODULES = sorted(p for p in PKG.rglob("*.py"))


# the scripts that drive the port on the card stand alone too
SCRIPTS = [PKG.parent / "chip_smoke.py", PKG.parent / "scripts/torch_port_profile.py",
           PKG.parent / "scripts/dist_scaling.py", PKG.parent / "scripts/f32_forms_ab.py",
           PKG.parent / "scripts/bwd_classes.py", PKG.parent / "scripts/bwd_rows_ab.py"]


def _assert_names_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "ogmm_tpu"), \
                f"{path} imports {name}"


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_source_names_no_jax(path):
    _assert_names_no_jax(path)


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_scripts_name_no_jax(path):
    _assert_names_no_jax(path)


def test_the_data_pipeline_and_the_cli_are_covered():
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"data/datautils.py", "data/transforms.py", "data/modelnet.py",
            "data/loader.py", "train/cli.py", "train/__main__.py"} <= names


def test_the_model_surface_is_covered():
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"compat.py", "data/geometry.py", "ops/grid_nn.py", "ops/icp.py",
            "api.py", "train/checkpoint.py"} <= names


def test_the_kernels_of_every_slice_are_covered():
    from ogmm_tpu_torch.ops import dispatch
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"ops/cuda_knn.py", "ops/cuda_posenc.py", "ops/cuda_em.py",
            "ops/cuda_dgcnn.py", "ops/cuda_dgcnn_train.py",
            "ops/cuda_dgcnn_bwd.py", "ops/cuda_stream.py",
            "ops/stream.py", "ops/cuda_fps.py", "ops/cuda_icp.py",
            "ops/cuda_mlp.py"} <= names
    # every kernel source is built, and none is left out of the build (a
    # source may give several libraries: dgcnn_bwd.cu one a row class)
    sources = {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert sources == {dispatch._source(name)[0].stem for name in dispatch.SOURCES}
    assert {"knn", "posenc_angles", "dgcnn_edges", "knn_stream",
            "nn1_stream", "wproject", "fps", "icp",
            "pointmlp"} <= set(dispatch.KERNELS)
    # every TPU kernel of the JAX package has its counterpart
    assert len(dispatch.KERNELS) == 16


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            .removesuffix(".__init__") for p in MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ogmm_tpu', 'triton', 'h5py')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(PKG.parent)})
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_refuse_a_missing_card():
    import torch
    from ogmm_tpu_torch.api import Registrar
    from ogmm_tpu_torch.ops.dispatch import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Registrar()


def _public_functions(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


@pytest.mark.parametrize("jax_module,port_module", [
    ("parallel/sp.py", "ogmm_tpu_torch.parallel"),
    ("train/distributed.py", "ogmm_tpu_torch.train.distributed")])
def test_the_distribution_names_have_counterparts(jax_module, port_module):
    """Every public function of the JAX package's `parallel/` and
    `train/distributed.py` has its namesake in the port (read from the
    source: nothing of the JAX package is imported), and `parallel/` is a
    package of the port, held by the no-JAX checks above."""
    import importlib
    names = _public_functions(PKG.parent / "ogmm_tpu" / jax_module)
    assert names
    mod = importlib.import_module(port_module)
    assert all(hasattr(mod, n) for n in names), names
    port = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"parallel/__init__.py", "parallel/sp.py", "parallel/comm.py",
            "parallel/launch.py", "train/distributed.py"} <= port


# The JAX package's public names that need no counterpart: its Pallas
# kernels' modules (each has a Hopper kernel under csrc/, PERF.md's table),
# and the switches of its dispatch that exist for JAX alone (whether Pallas
# kernels run, and jax.debug callbacks); and the names the port gives
# another name, each mapped to the port's.
JAX_ONLY = {"ops/dispatch.py": {"set_pallas", "use_pallas", "pallas_override",
                                "set_debug_callbacks", "debug_callbacks",
                                "debug_callbacks_override"}}
RENAMED = {"ops/dgcnn_train.py": {"dgcnn_train_fused": "dgcnn_train"}}
JAX_PKG = PKG.parent / "ogmm_tpu"
JAX_MODULES = sorted(p for p in JAX_PKG.rglob("*.py")
                     if not p.name.startswith("pallas_"))


def _public_names(path):
    """The top-level public functions and classes of a module, from its
    source (nothing is imported)."""
    tree = ast.parse(path.read_text())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


@pytest.mark.parametrize("path", JAX_MODULES, ids=lambda p: str(p.relative_to(JAX_PKG)))
def test_every_public_name_of_the_jax_package_has_a_counterpart(path):
    """Each top-level public def or class of a module of `ogmm_tpu/` is a
    name of the port's module at the same path (defined there or imported
    into it), but for the JAX-only switches and the renamed names above: a
    new public name of the JAX package without a counterpart fails here."""
    import importlib
    rel = str(path.relative_to(JAX_PKG))
    port_path = PKG / rel
    assert port_path.exists(), f"no counterpart of ogmm_tpu/{rel}"
    mod = importlib.import_module(
        ".".join(port_path.relative_to(PKG.parent).with_suffix("").parts)
        .removesuffix(".__init__"))
    renamed = RENAMED.get(rel, {})
    missing = sorted(name for name in _public_names(path) - JAX_ONLY.get(rel, set())
                     if not hasattr(mod, renamed.get(name, name)))
    assert not missing, f"ogmm_tpu/{rel}: no counterpart in the port of {missing}"


def test_the_exceptions_of_the_name_check_are_real():
    # each excepted or renamed name is a public name of its JAX module, and
    # each renamed one's counterpart exists, so that the lists cannot go stale
    for rel, names in JAX_ONLY.items():
        assert names <= _public_names(JAX_PKG / rel), rel
    for rel, names in RENAMED.items():
        assert set(names) <= _public_names(JAX_PKG / rel), rel
        assert set(names.values()) <= _public_names(PKG / rel), rel
    assert all(p.name.startswith("pallas_") for p in JAX_PKG.rglob("*.py")
               if p not in JAX_MODULES)
