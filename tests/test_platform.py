"""Platform plumbing: compile-cache location, published peaks, the
auto device dispatch, and host-only multi-host workers."""

import os

import jax
import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import encode as enc_mod
from qvz_tpu.utils import compile_cache, roofline


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_wins(monkeypatch, tmp_path, cache_dir_restored):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing else
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, "build", "jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_peaks_for_h100_rows():
    sxm = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert (sxm.hbm_gbps, sxm.bf16_tflops, sxm.int8_tops) == \
        (3350.0, 989.0, 1979.0)
    pcie = roofline.peaks_for("NVIDIA H100 PCIe")
    assert pcie.hbm_gbps < sxm.hbm_gbps
    u = roofline.utilization(int(3.35e12), 1.0, sxm)
    assert u["pct_hbm_peak"] == 100.0


@pytest.mark.parametrize(
    "kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100"])
def test_peaks_for_unknown_device_raises(kind):
    with pytest.raises(ValueError):
        roofline.peaks_for(kind)


def test_auto_dispatch_is_host_engine_on_cpu(monkeypatch):
    """use_jax='auto' engages the device only on a GPU backend: on the
    CPU backend even a zero size threshold runs the C++ host engine."""
    monkeypatch.setenv("QVZ_TPU_DEVICE_MIN_BYTES", "0")
    rng = np.random.default_rng(3)
    data = np.clip(30 + rng.integers(-2, 3, size=(600, 10)).cumsum(1),
                   0, 71).astype(np.uint8)
    kw = dict(well_state=WellState.debug(), shards=0)
    dist = make_matrix(DISTORTION_MSE)
    auto = enc_mod.encode(data, dist, **kw)
    host = enc_mod.encode(data, dist, use_jax=False, **kw)
    assert auto.stats.device_seconds == {}
    assert auto.compressed == host.compressed


def test_multihost_workers_never_import_jax(tmp_path, monkeypatch):
    """Workers run the host engine only: a `jax` package that raises on
    import, first on the workers' path, must not be touched."""
    from qvz_tpu.parallel.multihost import encode_multihost
    from qvz_tpu.spec.pipeline import lines_to_bytes

    fake = tmp_path / "fakejax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('multi-host worker imported jax')\n")
    monkeypatch.setenv("PYTHONPATH", str(fake.parent))
    rng = np.random.default_rng(9)
    data = np.clip(30 + rng.integers(-2, 3, size=(2000, 12)).cumsum(1),
                   0, 71).astype(np.uint8)
    path = tmp_path / "in.qual"
    path.write_bytes(lines_to_bytes(data))
    dist = make_matrix(DISTORTION_MSE)
    multi, _ = encode_multihost(str(path), n_hosts=2, shards=4,
                                n_clusters=2, dist_matrix=dist,
                                well_state=WellState.debug())
    single = enc_mod.encode(data, dist, n_clusters=2, shards=4,
                            use_jax=False, well_state=WellState.debug())
    assert multi == single.compressed
