"""Public library API.

    import qvz_tpu.api as qvz

    stats = qvz.compress("reads.qual", "reads.q", ratio=0.5)
    qvz.decompress("reads.q", "reads.dec")

    blob, stats = qvz.compress_bytes(open("reads.qual","rb").read())
    text = qvz.decompress_bytes(blob)

Thin wrappers over the pipeline (pipeline/encode.py, pipeline/decode.py)
with the same semantics as the CLI; see that module's docstrings for the
full parameter reference.
"""

from __future__ import annotations

import numpy as np

from qvz_tpu.constants import (  # noqa: F401  (re-exported)
    DISTORTION_CUSTOM,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_MSE,
    MODE_FIXED,
    MODE_RATIO,
)
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.utils.compile_cache import enable_compile_cache


def _well(seed: bytes | None, debug: bool) -> WellState:
    if seed is not None:
        return WellState.from_bytes(seed)
    if debug:
        return WellState.debug()
    import os
    return WellState(np.frombuffer(os.urandom(128), dtype="<u4").tolist())


def compress_bytes(data: bytes, *, mode: int = MODE_RATIO,
                   ratio: float = 0.5, clusters: int = 1,
                   distortion: int = DISTORTION_MSE,
                   distortion_file: str | None = None,
                   cluster_threshold: float = 4.0,
                   shards: int = 1,
                   well_seed: bytes | None = None,
                   debug_seed: bool = False,
                   use_jax: bool | str = "auto",
                   prime: bool = True):
    """Compress raw quality-file bytes. Returns (container bytes, stats).

    shards=1 emits the reference-compatible v1 container; shards>1 (or 0
    for one per CPU) emits the parallel QVZ2 container with identical
    reconstruction (primed by default: near-v1 rate; prime=False keeps
    shards independently decodable).
    """
    from qvz_tpu.pipeline import encode as enc_mod
    from qvz_tpu.spec.pipeline import load_quality_file

    enable_compile_cache()
    arr = load_quality_file(data)
    dist = make_matrix(distortion, path=distortion_file)
    out = enc_mod.encode(arr, dist, n_clusters=clusters, mode=mode,
                         ratio=ratio, cluster_threshold=cluster_threshold,
                         well_state=_well(well_seed, debug_seed),
                         use_jax=use_jax, shards=shards, want_recon=False,
                         prime=prime)
    return out.compressed, out.stats


def decompress_bytes(container: bytes,
                     device: bool | None = None) -> bytes:
    """Decompress a v1 or QVZ2 container to quality text (with newlines).

    device=True decodes QVZ2 shards in accelerator lanes (byte-equal to
    the host decoder; see pipeline.decode.decode)."""
    from qvz_tpu.pipeline import decode as dec_mod
    enable_compile_cache()
    return dec_mod.decode(container, device=device).tobytes()


def compress(input_path: str, output_path: str, **kwargs):
    """File-to-file compression; kwargs as compress_bytes plus
    hosts=N for the multi-host driver (byte-identical container).
    Returns stats."""
    hosts = kwargs.pop("hosts", 1)
    if hosts > 1:
        from qvz_tpu.parallel.multihost import encode_multihost
        compressed, mh = encode_multihost(
            input_path, n_hosts=hosts,
            shards=kwargs.pop("shards", 0) or 0,
            n_clusters=kwargs.pop("clusters", 1),
            mode=kwargs.pop("mode", MODE_RATIO),
            ratio=kwargs.pop("ratio", 0.5),
            cluster_threshold=kwargs.pop("cluster_threshold", 4.0),
            well_state=_well(kwargs.pop("well_seed", None),
                             kwargs.pop("debug_seed", False)),
            dist_matrix=make_matrix(
                kwargs.pop("distortion", DISTORTION_MSE),
                path=kwargs.pop("distortion_file", None)),
            prime=kwargs.pop("prime", True))
        with open(output_path, "wb") as f:
            f.write(compressed)
        return mh
    from qvz_tpu.pipeline import encode as enc_mod
    from qvz_tpu.spec.pipeline import load_quality_file

    enable_compile_cache()
    arr = load_quality_file(input_path)
    dist = make_matrix(kwargs.pop("distortion", DISTORTION_MSE),
                       path=kwargs.pop("distortion_file", None))
    out = enc_mod.encode(
        arr, dist,
        n_clusters=kwargs.pop("clusters", 1),
        mode=kwargs.pop("mode", MODE_RATIO),
        ratio=kwargs.pop("ratio", 0.5),
        cluster_threshold=kwargs.pop("cluster_threshold", 4.0),
        well_state=_well(kwargs.pop("well_seed", None),
                         kwargs.pop("debug_seed", False)),
        use_jax=kwargs.pop("use_jax", "auto"),
        shards=kwargs.pop("shards", 1), want_recon=False, **kwargs)
    with open(output_path, "wb") as f:
        f.write(out.compressed)
    return out.stats


def decompress(input_path: str, output_path: str,
               device: bool | None = None) -> int:
    """File-to-file decompression (memory-mapped both ways). Returns
    the number of lines. device= as in decompress_bytes."""
    from qvz_tpu.pipeline import decode as dec_mod
    enable_compile_cache()
    return dec_mod.decode_file_to_file(input_path, output_path,
                                       device=device)
