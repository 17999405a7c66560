"""Out-of-process crash-drill worker for the port (driven by
tests/test_torch_recovery.py), the twin of tests/_crash_drill_worker.py.

``serve`` mode runs a fixed seeded workload to completion through the
port's ``DurableFrontend`` on the CPU, writing a progress file after every
pump; the parent test SIGKILLs it mid-workload, so every write here is
crash-ordered (the journal's fsyncs are the frontend's; the marker files
are written to a temporary name and renamed). ``recover`` mode starts a
fresh interpreter over the same workdir, reconstructs the frontend from
snapshot + journal alone (``DurableFrontend.recover``), finishes the
workload and writes its results, to be compared with an uninterrupted
control. Imports torch and the port only.

Usage: python tests/_torch_crash_drill_worker.py <serve|recover> <workdir>
       <policy> <sleep_s>
"""
import json
import os
import sys
import time


def _atomic_write(path, text):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _results(dfe):
    return {
        "tickets": [
            dict(tid=t.tid, status=t.status, reason=t.reason,
                 tokens=(None if t.tokens is None
                         else [[int(x) for x in tok] for tok in t.tokens]))
            for t in dfe.fe.tickets],
        "stats": dict(dfe.stats),
    }


def main():
    mode, workdir, policy = sys.argv[1], sys.argv[2], sys.argv[3]
    sleep_s = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
    os.makedirs(workdir, exist_ok=True)

    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig, TreeConfig
    from repro_torch.models import get_model
    from repro_torch.runtime.recovery import DurableFrontend
    from repro_torch.runtime.serve import TreeServeEngine

    torch.set_num_threads(1)
    cfg = ModelConfig(name="crash-drill", family="dense", n_layers=2,
                      d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                      d_ff=64, vocab_size=64, vocab_pad_multiple=16,
                      decode_capacity=8)
    model = get_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)

    def factory():
        return TreeServeEngine(model, cfg, TreeConfig(
            n_nodes=6, depth=2, slots=4, node_capacity=16,
            decode_capacity=8, temperature=0.0, ctx_store="paged",
            page_size=8, num_pages=8, prefix_cache=True,
            suffix_prefill=True))

    dfe = DurableFrontend(
        factory, workdir, snapshot_every=2, device="cpu",
        frontend_kwargs=dict(policy=policy, decode_steps=1, stall_rounds=6))

    # two shared prefixes, six mixed requests: enough rounds
    # (decode_steps=1) that the parent's kill lands mid-workload
    rng = np.random.RandomState(7)
    prefixes = [torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, 12)))
                for _ in range(2)]
    reqs = [(prefixes[i % 2],
             torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, 3 + i % 4))),
             1 + i % 2, i % 2) for i in range(6)]

    progress = os.path.join(workdir, "progress.txt")
    if mode == "serve":
        dfe.init_state()
        for pfx, sfx, n_samples, priority in reqs:
            dfe.submit([pfx, sfx], n_samples=n_samples, max_new_tokens=6,
                       priority=priority)
        while dfe.pending():
            dfe.pump(params)
            _atomic_write(progress, f"{dfe.fe.round}\n")
            if sleep_s:
                time.sleep(sleep_s)
        _atomic_write(os.path.join(workdir, "done.json"),
                      json.dumps(_results(dfe)))
    elif mode == "recover":
        # a fresh interpreter: NO init_state (it would lay a new empty
        # base snapshot over the one to recover from)
        dfe.recover(params)
        guard = 0
        while dfe.pending():
            guard += 1
            assert guard < 200, "recovered drain did not converge"
            dfe.pump(params)
        _atomic_write(os.path.join(workdir, "result.json"),
                      json.dumps(_results(dfe)))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
