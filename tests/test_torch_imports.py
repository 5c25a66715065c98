"""The port stands alone: importing it loads neither JAX nor the JAX
package (nor ``ml_dtypes``, JAX's bf16), no module of it (or
``chip_smoke.py``) imports them, and the port
reaches no library attention/normalisation kernel, no ``torch.compile`` and
no backend setting from the environment."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)
# the library's norms in every spelling (functional calls, imports of the
# functions, the modules); the port's own ``kernels.rms_norm`` is allowed
LIBRARY_RE = re.compile(
    r"scaled_dot_product_attention|(?:\bF|functional|torch)\.(?:layer_norm|rms_norm)\(|"
    r"from\s+torch[\w.]*\s+import[^\n]*\b(?:layer_norm|rms_norm)\b|"
    r"nn\.(?:LayerNorm|RMSNorm)\b|torch\.compile|os\.environ|getenv"
)


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels, repro_torch.convert\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.models.ssm, repro_torch.launch.train, repro_torch.launch.profile_train\n"
        "import repro_torch.models.rglru, repro_torch.configs.recurrentgemma_9b\n"
        "import repro_torch.data.packing, repro_torch.kernels.flash_attention.ring\n"
        "import repro_torch.configs.tinyllama_1_1b\n"
        "import repro_torch.core, repro_torch.core.balancer, repro_torch.core.cost_model\n"
        "import repro_torch.core.dispatch, repro_torch.core.scheduler\n"
        "import repro_torch.core.simulator, repro_torch.core.telemetry\n"
        "import repro_torch.checkpoint.store, repro_torch.distributed.chaos\n"
        "import repro_torch.distributed.fault_tolerance, repro_torch.train.loop\n"
        "import repro_torch.core.shape_bench, repro_torch.distributed.plan_exec\n"
        "import repro_torch.launch.mesh, repro_torch.examples.serve_lm\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.specs\n"
        "import repro_torch.launch.comm_stats, repro_torch.launch.dryrun\n"
        "import repro_torch.kernels.meta\n"
        "from repro_torch.train.engine import MeshEngine\n"
        "from repro_torch.train.loop import Trainer; Trainer.__init__\n"
        "from repro_torch.distributed.fault_tolerance import RankZeroRunner\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes']\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_neither_jax_nor_repro(path):
    assert not IMPORT_RE.search(path.read_text()), path


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_kernel_or_environment(path):
    assert not LIBRARY_RE.search(path.read_text()), path


@pytest.mark.parametrize("rel", ["core/shape_bench.py", "distributed/plan_exec.py",
                                 "launch/mesh.py", "train/engine.py", "train/loop.py",
                                 "distributed/sharding.py", "launch/specs.py",
                                 "launch/comm_stats.py", "launch/dryrun.py", "kernels/meta.py"])
def test_mesh_and_shape_bench_modules_are_scanned(rel):
    """The modules of step-plan execution across processes, of the Shape
    Benchmark and of the dry run are among the sources scanned above."""
    assert PORT / rel in PORT_FILES


def test_the_dry_run_sets_no_xla_flags():
    """The reference's dry run sets ``XLA_FLAGS`` before importing JAX; the
    port's sets nothing of the environment and imports nothing of JAX."""
    src = (PORT / "launch" / "dryrun.py").read_text()
    assert "XLA_FLAGS" not in src and "jax" not in src.replace("ajax", "")


def test_every_module_of_the_reference_has_a_counterpart():
    """Each ``.py`` module of the JAX package has one in the port, under the
    same path, but ``launch/hlo_stats.py``, whose counterpart is
    ``launch/comm_stats.py`` (named in its docstring)."""
    ref = ROOT / "src" / "repro"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if not (PORT / p.relative_to(ref)).exists()]
    assert missing == ["launch/hlo_stats.py"]
    assert "repro.launch.hlo_stats" in (PORT / "launch" / "comm_stats.py").read_text()
