"""Telecom paging (the paper's §I motivating system, ref [1]) on the
PyTorch/CUDA port: ``examples/telecom_paging.py`` line for line on
``repro_torch``, the same sizes and seeds, so it prints the same numbers.

A cellular network is a directed graph: base stations are nodes, user
movement are edges.  When a user's location is unknown, the network pages a
*set* of cells such that P(user found) >= threshold — exactly MCPrioQ's
cumulative-probability query.  This example simulates user mobility, learns
the transition graph online, and measures paging success vs. cells paged.

    PYTHONPATH=src python examples/torch_telecom_paging.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import mcprioq as mc
from repro_torch.data.synthetic import MarkovGraphSampler


def mean32(x: torch.Tensor) -> float:
    """The mean as the reference's ``np.mean`` of a jax array computes it:
    a float32 sum times float32 ``1/n``, so the printed digits agree."""
    inv_n = torch.tensor(1.0 / x.numel(), dtype=torch.float32, device=x.device)
    return float(x.to(torch.float32).sum() * inv_n)


def main(device=None):
    n_cells = 400
    mobility = MarkovGraphSampler(num_nodes=n_cells, out_degree=12,
                                  zipf_s=1.6, seed=42)
    cfg = mc.MCConfig(num_rows=512, capacity=16, sort_passes=1)
    state = mc.init(cfg, device=device)

    # --- phase 1: learn handover transitions online -----------------------
    for _ in range(80):
        src, dst = mobility.sample_transitions(1024)
        state = mc.update_batch(state, src, dst, cfg=cfg)

    # --- phase 2: page unknown-location users -----------------------------
    for threshold in (0.5, 0.8, 0.95):
        last_cell, true_next = mobility.sample_transitions(2000)
        dsts, probs, n_needed = mc.query_threshold(
            state, last_cell, threshold, cfg=cfg, max_items=16)
        dsts = dsts.cpu().numpy()
        found = (dsts == true_next[:, None]).any(axis=1)
        print(f"t={threshold:4.2f}: paged "
              f"{mean32(n_needed):5.2f} "
              f"cells on average -> user found {found.mean():6.1%} "
              f"(target {threshold:.0%})")

    # --- phase 3: topology change (new cell tower) + decay ----------------
    # decay lets the chain forget the old neighbour distribution (§II.C)
    state = mc.decay(state, cfg=cfg)
    mobility2 = MarkovGraphSampler(num_nodes=n_cells, out_degree=12,
                                   zipf_s=1.6, seed=43)  # re-planned network
    for _ in range(80):
        src, dst = mobility2.sample_transitions(1024)
        state = mc.update_batch(state, src, dst, cfg=cfg)
    last_cell, true_next = mobility2.sample_transitions(2000)
    dsts, _, n_needed = mc.query_threshold(
        state, last_cell, 0.8, cfg=cfg, max_items=16)
    found = (dsts.cpu().numpy() == true_next[:, None]).any(axis=1)
    print(f"\nafter topology change + decay: paged "
          f"{mean32(n_needed):.2f} cells, found "
          f"{found.mean():.1%} (graph re-learned online, no retraining)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the chain lives (default: the GPU)")
    main(None if ap.parse_args().device == "cuda" else "cpu")
