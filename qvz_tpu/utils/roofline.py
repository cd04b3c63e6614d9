"""Device-utilization accounting: achieved bytes/s per
kernel vs the card's published peaks.

The reference publishes no performance model at all (SURVEY §6), so
this yardstick is the framework's own. The compressor's device kernels
are gather/scatter/integer-ALU passes, not matmuls — the binding
resource is device-memory bandwidth, so the headline figure is
pct_hbm_peak on explicit input+output traffic.

Peaks are keyed on jax.devices()[0].device_kind; a device missing from
the table is an error, not a default. The rates assume the card's full
power limit: report its `power.limit` beside any share of them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipPeaks:
    name: str
    hbm_gbps: float        # device-memory bandwidth, GB/s
    bf16_tflops: float     # dense bf16 tensor-core peak, TFLOP/s
    int8_tops: float       # dense int8 tensor-core peak, TOP/s


# NVIDIA H100 data sheet, dense rates (without sparsity).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks("H100 SXM", 3350.0, 989.0, 1979.0),
    "NVIDIA H100 PCIe": ChipPeaks("H100 PCIe", 2000.0, 756.0, 1513.0),
}


def peaks_for(device_kind: str) -> ChipPeaks:
    try:
        return _PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(_PEAKS)}") from None


def utilization(bytes_moved: int, seconds: float,
                peaks: ChipPeaks) -> dict:
    """Achieved rates + fraction of peak for one timed kernel pass.

    bytes_moved: explicit kernel input + output bytes (device-memory
    model; intermediates kept on chip excluded by construction)."""
    gbs = bytes_moved / seconds / 1e9 if seconds > 0 else 0.0
    return {
        "achieved_GB_s": round(gbs, 2),
        "pct_hbm_peak": round(100.0 * gbs / peaks.hbm_gbps, 2),
        "chip": peaks.name,
    }


# --- per-kernel explicit-traffic models (bytes per pass) ---------------
# N lines x C columns, K centroids.


def hist_bytes(n: int, cols: int, n_clusters: int) -> int:
    # read data u8 (n*cols) + cluster ids u8 (n); write histograms
    # (n_clusters*72 + n_clusters*(cols-1)*72*72) i32.
    return (n * cols + n
            + 4 * n_clusters * (72 + (cols - 1) * 72 * 72))


def kmeans_bytes(n: int, cols: int, k: int) -> int:
    # read data u8 (n*cols), centroids i32; write assignment i32 (n) +
    # centroid sums/counts i32.
    return n * cols + 4 * (k * cols + n + k * cols + k)


def quantize_bytes(n: int, cols: int) -> int:
    # read data + draws u8; write model_ids/qs/qv i32.
    return 2 * n * cols + 4 * 3 * n * cols
