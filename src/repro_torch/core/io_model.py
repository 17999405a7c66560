"""Analytic memory-IO model of one prefix-trie decode step.

The port's copy of ``tree_decode_io_bytes`` from the reference's
``repro/core/io_model.py``, at the reference's defaults (bf16 nodes, one
query row per slot, live node lengths); the rest of that module is not
ported yet. ``TreeServeEngine.step_io_bytes`` reads it.
"""
from __future__ import annotations


def tree_decode_io_bytes(*, paths, node_lens, c_d, g, hd) -> dict:
    """Per-NODE byte accounting for one prefix-trie decode step, per layer.

    ``paths``: one entry per decode slot, each a sequence of trie-node ids
    (root first; variable length <= the depth). ``node_lens[i]`` is node
    ``i``'s live token count. Every node REFERENCED by >= 1 slot is read
    ONCE (bf16), plus the per-slot decode arms and the q/out rows —
    ancestors shared by many paths are read once, not once per distinct
    full prefix.

    Returns {"per_node": {node_id: bytes}, "total": int}.
    """
    used = sorted({nid for pth in paths for nid in pth})
    per_node = {nid: 2 * g * int(node_lens[nid]) * hd * 2 for nid in used}
    b = len(paths)
    dec = 2 * g * b * c_d * hd * 2
    q_io = out_io = b * g * hd * 2
    return {"per_node": per_node,
            "total": sum(per_node.values()) + dec + q_io + out_io}
