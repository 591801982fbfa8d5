"""Roofline terms of a dry-run cell, ported from
``repro.roofline.analysis``.

Three terms per (arch × shape × mesh), all in seconds:

    compute    = flops       / (chips · peak flop rate)
    memory     = bytes       / (chips · memory bandwidth)
    collective = coll_bytes  / (chips · link bandwidth)

The figures are module totals (one rank's count × chips), as the
reference's are.  The rates are a :class:`Hardware`'s, by default one
H100 SXM5 80GB's datasheet peaks; the reference's module constants are
another chip's and have no place here.

:func:`analyze` builds the reference's cost dict from the port's counter
(:mod:`repro_torch.roofline.counter`), where the reference's
``analyze_compiled`` parses XLA's compiled program.  The reference's
``collective_stats``, ``extract_cost`` and ``parse_memory_analysis`` read
XLA's compiled text and objects and have no counterpart: the port has no
compiled artifact, and its dry-run takes per-rank memory from the
placements of the arguments and outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one device.  Defaults: NVIDIA H100 SXM5 80GB, from
    NVIDIA's H100 Tensor Core GPU datasheet — bf16 dense tensor-core
    989.4 TFLOP/s, fp32 without tensor cores 66.9 TFLOP/s, HBM3
    3.35 TB/s, NVLink 4 at 900 GB/s in all, 450 GB/s each way."""
    name: str = "H100 SXM5 80GB (datasheet)"
    peak_flops: float = 989.4e12      # bf16 dense, tensor cores
    peak_flops_fp32: float = 66.9e12  # fp32, no tensor cores
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 450e9            # bytes/s, one direction

    def peak(self, dtype: str) -> float:
        """The peak flop rate for work in ``dtype`` (a torch type's name):
        fp32 runs without tensor cores, as the port's fp32 products do
        (TF32 off); every other type at the bf16 tensor-core rate."""
        return self.peak_flops_fp32 if dtype == "float32" else \
            self.peak_flops


H100 = Hardware()


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # module total (per-rank × chips)
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    per_device_hbm: Optional[float] = None
    dot_flops: float = 0.0         # matmul-only flops (remat-waste view)
    coll_counts: Optional[dict] = None
    hw: Hardware = dataclasses.field(default=H100, repr=False)
    dtype: str = "bfloat16"        # the counted work's type: its peak

    @property
    def t_compute(self):
        return self.hlo_flops / (self.chips * self.hw.peak(self.dtype))

    @property
    def t_memory(self):
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self):
        return self.collective_bytes / (self.chips * self.hw.link_bw)

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self):
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self):
        """compute-term share of the max term — 1.0 means perfectly
        compute-bound (the roofline)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    def row(self):
        """The reference's row, key for key (the hardware and the type
        stay out).
        ``per_device_hbm`` is, in the port's dry-run, one rank's
        arguments and outputs from their placements: the activations'
        temporaries are not counted, where the reference's figure adds
        XLA's temp buffer."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "dot_flops": self.dot_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_hbm": self.per_device_hbm,
            "coll_counts": self.coll_counts,
        }


def analyze(counter, *, chips: int):
    """The reference's cost dict from one rank's
    :class:`~repro_torch.roofline.counter.Counter`: module totals (that
    rank's figures × chips) of flops, dot flops, bytes and collective
    bytes, and the rank's collective counts by kind."""
    return {
        "flops": counter.flops * chips,
        "dot_flops": counter.dot_flops * chips,
        "bytes": counter.bytes * chips,
        "collective_bytes": counter.collective_bytes * chips,
        "coll_counts": dict(counter.coll_counts),
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params."""
    n = cfg.active_param_count
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
