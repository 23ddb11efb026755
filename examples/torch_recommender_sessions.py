"""Recommender system over user sessions (the paper's primary use case) on
the PyTorch/CUDA port: ``examples/recommender_sessions.py`` line for line
on ``repro_torch``, the same sizes and seeds, so it prints the same
numbers.

Item-to-item collaborative filtering: every user session is a walk over the
item graph; MCPrioQ learns item->item transition counts online and serves
"recommend items until P(match) >= t" queries concurrently with learning
(epoch snapshots = the RCU read side).

    PYTHONPATH=src python examples/torch_recommender_sessions.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import mcprioq as mc
from repro_torch.core.epoch import EpochStore
from repro_torch.data.synthetic import MarkovGraphSampler


def mean32(x: torch.Tensor) -> float:
    """The mean as the reference's ``np.mean`` of a jax array computes it:
    a float32 sum times float32 ``1/n``, so the printed digits agree."""
    inv_n = torch.tensor(1.0 / x.numel(), dtype=torch.float32, device=x.device)
    return float(x.to(torch.float32).sum() * inv_n)


def main(device=None):
    catalogue = MarkovGraphSampler(num_nodes=1000, out_degree=24,
                                   zipf_s=1.5, seed=1)
    cfg = mc.MCConfig(num_rows=1024, capacity=32, sort_passes=1)
    store = EpochStore(mc.init(cfg, device=device))

    hit_at_list, items_shown = [], []
    for epoch in range(40):
        # ---- learner thread: ingest a batch of session transitions -------
        sessions = catalogue.sample_walks(batch=64, length=8)
        src = sessions[:, :-1].reshape(-1)
        dst = sessions[:, 1:].reshape(-1)
        snap = store.acquire()
        try:
            # the functional update writes a copy: the snapshot stays as is
            new_state = mc.update_batch(snap.state, src, dst, cfg=cfg)
        finally:
            store.release(snap)
        store.publish(new_state)  # RCU publish: readers never see torn state

        # ---- serving threads: recommend against the published snapshot ---
        snap = store.acquire()
        try:
            cur, nxt = catalogue.sample_transitions(256)
            recs, _, n_needed = mc.query_threshold(
                snap.state, cur, 0.8, cfg=cfg, max_items=16)
        finally:
            store.release(snap)
        hits = (recs.cpu().numpy() == nxt[:, None]).any(axis=1)
        hit_at_list.append(hits.mean())
        items_shown.append(mean32(n_needed))

    print("epoch  hit-rate  items-shown (t=0.8)")
    for e in (0, 4, 9, 19, 39):
        print(f"{e:5d}  {hit_at_list[e]:7.1%}  {items_shown[e]:6.2f}")
    print(f"\npublished versions: {store.version} "
          f"(readers never blocked; retired {len(store.retired_versions)})")
    assert hit_at_list[-1] > hit_at_list[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chain lives (default: the GPU)")
    main(None if ap.parse_args().device == "cuda" else "cpu")
