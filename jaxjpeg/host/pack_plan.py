"""Host-side layout of the PACK stream for the device expander.

The packed stream (host/entropy.py, reference format xjpeg.c:484-535) is
already in scan order; the device needs only it and the index of each
block's first entry in scan order (MCU-interleaved: components in scan
order, sub-blocks row-major).  Unlike the device *entropy* path this needs
no restart markers: the host already did the Huffman work; pack mode only
minimises upload bytes (2 bytes per non-zero symbol vs dense coefficient
tensors).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jaxjpeg.host.entropy import ScanResult
from jaxjpeg.host.parser import ParsedJpeg


@dataclasses.dataclass
class PackPlan:
    entries: np.ndarray        # (N,) uint16 packed stream, scan order
    block_starts: np.ndarray   # (n_mcus * bpm,) int32, scan order
    blocks_per_mcu: int

    @property
    def packed_entries(self) -> int:
        """Total entries (the upload size metric)."""
        return int(self.entries.size)


def build_pack_plan(parsed: ParsedJpeg, scan: ScanResult) -> PackPlan:
    """Scan-ordered block starts for the device expander."""
    header = parsed.header
    assert scan.pack is not None and scan.pack_index is not None
    comps = [header.components[i] for i in header.scan.comp_idx]
    per_comp = []
    for ci, c in zip(header.scan.comp_idx, comps):
        idx = np.asarray(scan.pack_index[ci])  # frame order, (vb, hb)
        idx = idx.reshape(header.nvmb, c.vsamp, header.nhmb, c.hsamp)
        per_comp.append(
            idx.transpose(0, 2, 1, 3).reshape(header.n_mcus, -1)
        )
    starts = np.concatenate(per_comp, axis=1).reshape(-1)
    return PackPlan(
        entries=np.asarray(scan.pack, dtype=np.uint16),
        block_starts=np.ascontiguousarray(starts, dtype=np.int32),
        blocks_per_mcu=sum(c.hsamp * c.vsamp for c in comps),
    )
