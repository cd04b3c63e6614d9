"""qvz_tpu — an accelerator-native quality-value compression engine.

A from-scratch JAX/XLA framework with the capabilities of the QVZ
quality-score codec (k-means read clustering, first-order Markov context
modeling, Lloyd-Max distortion-optimized quantizer design with stochastic
dithering, and context-adaptive arithmetic coding), producing bitstreams
that are byte-identical to the reference format.

Architecture:
  * Heavy O(reads x columns) passes run on the GPU via JAX/XLA
    (clustering, conditional histograms, batched quantization, the
    lane-parallel entropy coder and decoder).
  * Exact-semantics host runtime (WELL-1024a, Lloyd-Max codebook design,
    adaptive arithmetic coding) is native C++ reached through ctypes, with
    bit-identical pure-Python specification implementations used as test
    oracles.
  * Multi-chip scaling uses jax.sharding meshes with psum/all_gather
    collectives over the reads axis; multi-host scaling via
    parallel/multihost (process control plane, CLI --hosts) or
    parallel/distributed (jax.distributed global mesh).
  * Production formats: reference-compatible v1 (bit-exact both ways)
    and the sharded QVZ2 container (parallel streams, per-shard xxh64
    integrity, zero-byte-cost shard priming, identical reconstruction);
    tools/transcode converts between them losslessly.
  * Beyond-RAM corpora stream through pipeline/streaming (bounded
    memory, byte-identical containers).
"""

__version__ = "0.5.0"

from qvz_tpu.constants import (  # noqa: F401
    ALPHABET_SIZE,
    MODE_FIXED,
    MODE_RATIO,
    DISTORTION_MSE,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_CUSTOM,
)
