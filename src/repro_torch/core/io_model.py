"""Analytic memory-IO model of one prefix-trie decode step.

The port's copy of ``tree_decode_io_bytes`` from the reference's
``repro/core/io_model.py``, at the reference's defaults (bf16 nodes, one
query row per slot, live node lengths), and of its marginal form
``tree_admit_bytes_delta``; the rest of that module is not ported yet.
``TreeServeEngine.step_io_bytes`` reads the first, the sharing admission
policy (``runtime/scheduler.SharingPolicy``) prices with the second.
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


def tree_admit_bytes_delta(*, seg_lens, shared, n_slots, c_d, g, hd,
                           p=1, n=1, bytes_per_el=2) -> dict:
    """INCREMENTAL per-step byte delta of admitting ONE request into a
    live trie (per layer) — the marginal-gain form of
    ``tree_decode_io_bytes``, so an admission policy can score each
    queued candidate without recomputing the full per-node model per
    subset.

    ``seg_lens[i]`` is the token count of the request's path level ``i``
    (outermost first); ``shared[i]`` is True iff that level's node is
    ALREADY read each step — referenced by a live request, or by a
    candidate selected earlier in the same greedy pass. Shared levels
    add ZERO context bytes (the trie reads each referenced node once per
    step no matter how many paths traverse it — Eq. 6's b-fold saving);
    unshared levels add their full context read. The request's
    ``n_slots`` decode slots each add a decode arm plus q/out rows.

    Returns::

        {"ctx_delta":      context bytes/step ADDED (unshared levels),
         "dec_delta":      decode-arm + q/out bytes/step added,
         "total_delta":    ctx_delta + dec_delta,
         "shared_bytes":   context bytes/step AVOIDED (shared levels —
                           what a standard replay would have re-read),
         "saved_per_slot": shared_bytes / n_slots — the greedy score}

    Exactness contract (tested): for a candidate whose ``shared`` mask
    is computed against the referenced-node set of an existing ``paths``
    list, ``total_delta`` equals the difference of
    ``tree_decode_io_bytes(...)["total"]`` after vs before appending the
    candidate's ``n_slots`` paths (default live-length accounting).
    """
    if len(seg_lens) != len(shared):
        raise ValueError("seg_lens and shared must align")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    per_tok = 2 * g * hd * bytes_per_el
    ctx_delta = sum(int(m) for m, sh in zip(seg_lens, shared) if not sh) \
        * per_tok
    shared_bytes = sum(int(m) for m, sh in zip(seg_lens, shared) if sh) \
        * per_tok
    rows = n_slots * p * n
    dec_delta = (2 * g * n_slots * c_d * hd * bytes_per_el
                 + 2 * rows * g * hd * bytes_per_el)     # q + out rows
    return {
        "ctx_delta": ctx_delta,
        "dec_delta": dec_delta,
        "total_delta": ctx_delta + dec_delta,
        "shared_bytes": shared_bytes,
        "saved_per_slot": shared_bytes / n_slots,
    }
