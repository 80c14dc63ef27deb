"""Three-term roofline model for one NVIDIA H100: the port of
``repro/analysis/roofline.py``.

  t_comp = FLOPs_per_rank / peak_FLOPs
  t_mem  = HBM_bytes_per_rank / HBM_bw
  t_coll = collective_wire_bytes_per_rank / link_bw

The dry run's counts are per rank, so no further normalisation is
applied. The achievable step time under perfect overlap is the ``max`` of
the three terms (the HDOT ideal); the paper's two-phase baseline is
``t_comp + t_coll`` (serial communication phases). The roofline fraction
compares useful model FLOPs against the overlapped bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class HW:
    """Per-GPU constants of an NVIDIA H100 SXM5 80GB, from its data sheet:
    989e12 dense bf16 FLOP/s (tensor cores, no sparsity), 3.35e12 B/s of
    HBM3, 80e9 bytes of HBM.

    ``link_bw`` is the hop a 16-rank axis of the production meshes
    crosses: a node holds 8 GPUs on NVLink (450e9 B/s one way a GPU), so
    every 16-wide "data" or "model" axis spans two nodes, and a ring over
    it is limited by its inter-node edges, each a GPU's own NIC at 400
    Gb/s = 50e9 B/s one way. The ring model moves every rank's wire bytes
    over its slowest edge, so the NIC rate bounds the whole axis."""

    name: str = "nvidia-h100-sxm"
    peak_flops: float = 989e12        # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12           # B/s
    link_bw: float = 50e9             # B/s per GPU NIC (one direction)
    hbm_bytes: float = 80e9


H100 = HW()


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                  # per rank (the fake pass's FLOPs)
    hlo_bytes: float                  # per rank
    coll_bytes: float                 # per rank (ring-model wire)
    model_flops: float                # 6*N(_active)*D, GLOBAL
    hw: HW = field(default_factory=lambda: H100)
    arg_bytes: float = 0.0            # per rank, from memory_analysis
    temp_bytes: float = 0.0
    out_bytes: float = 0.0
    notes: str = ""

    # ------------------------------------------------------------------ terms
    @property
    def t_comp(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def t_mem(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_coll(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_step_overlapped(self) -> float:
        """HDOT bound: perfect overlap of the three engines."""
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def t_step_two_phase(self) -> float:
        """Paper-baseline bound: comm serializes with compute."""
        return max(self.t_comp, self.t_mem) + self.t_coll

    @property
    def t_useful(self) -> float:
        """Time the ranks would need for the useful model FLOPs alone."""
        return (self.model_flops / self.chips) / self.hw.peak_flops

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): catches remat and
        redundancy waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU bound at the overlapped step time."""
        t = self.t_step_overlapped
        return self.t_useful / t if t else 0.0

    @property
    def mem_fit(self) -> bool:
        resident = self.arg_bytes + self.out_bytes + self.temp_bytes
        return resident <= self.hw.hbm_bytes

    # ---------------------------------------------------------------- display
    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_comp_s": self.t_comp, "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "hbm_resident_gb": (self.arg_bytes + self.out_bytes
                                + self.temp_bytes) / 1e9,
            "mem_fit": self.mem_fit,
            "notes": self.notes,
        }

    def __str__(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                f"comp={self.t_comp*1e3:9.2f}ms mem={self.t_mem*1e3:9.2f}ms "
                f"coll={self.t_coll*1e3:9.2f}ms dom={self.dominant:10s} "
                f"useful={self.useful_flops_ratio:6.3f} "
                f"roofline={self.roofline_fraction:6.3f}")


def roofline(arch: str, shape: str, mesh: str, chips: int,
             hlo_flops: float, hlo_bytes: float, coll_bytes: float,
             model_flops: float, hw: Optional[HW] = None,
             **mem) -> RooflineReport:
    return RooflineReport(arch=arch, shape=shape, mesh=mesh, chips=chips,
                          hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
                          coll_bytes=coll_bytes, model_flops=model_flops,
                          hw=hw or H100, **mem)


def model_flops_for(num_params_active: int, tokens: int, kind: str,
                    backward: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd 2ND + bwd 4ND), 2*N*D for
    inference."""
    if kind == "train":
        return 6.0 * num_params_active * tokens
    return 2.0 * num_params_active * tokens
