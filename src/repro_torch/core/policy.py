"""Workload-based bifurcation switch (paper FAQ #4).

For small workloads the two-GEMM split can under-utilize the GEMM units, so
the paper recommends enabling bifurcated attention only above a workload
threshold — making it a strict latency win. We derive the switch from the
analytic memory-IO model (paper Eq. 5–6 + Table 5): bifurcate when the
modelled IO saving exceeds ``min_io_saving_bytes`` AND the batch is > 1.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BifurcationPolicy:
    enabled: bool = True
    min_batch: int = 2
    # Below this many bytes of modelled saving per layer, stay on the fused
    # single-GEMM path (kernel-launch/parallelism overhead regime).
    min_io_saving_bytes: int = 1 << 20

    def io_saving_bytes(self, *, batch, m_c, n_groups, head_dim, bytes_per_el=2) -> int:
        """Per-layer KV-read saving: g*k*b*m_c  ->  g*k*m_c (Eq. 5-6 delta)."""
        return 2 * n_groups * head_dim * m_c * (batch - 1) * bytes_per_el

    def should_bifurcate(self, *, batch, m_c, n_groups, head_dim, bytes_per_el=2) -> bool:
        if not self.enabled or batch < self.min_batch:
            return False
        saving = self.io_saving_bytes(
            batch=batch, m_c=m_c, n_groups=n_groups, head_dim=head_dim,
            bytes_per_el=bytes_per_el,
        )
        return saving >= self.min_io_saving_bytes
