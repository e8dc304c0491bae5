"""How often K1's hard labels flip against the plain version's, and what a
flip costs.

K1 and its plain version take the argmax of f32 dots summed in other
orders, so a token whose top two scores lie within their rounding may take
either label. Each draw is a 308-px database batch, [32, 484, 1536] unit
facets with 32 centers drawn from them (random, from a seed), run through
K1 twice (the two launches must be bit-equal) in hard cosine and hard
euclidean mode and held to the plain version by
``vlad_kernel.hard_label_agreement``: the near ties, the label flips, each
flipped image's cosine before the flip is explained (what it costs) and
the least cosine after. ``--planted T`` puts T tokens of each image on an
exact tie (the normalized sum of two centers), where a flip is a coin toss.

    python -m anyloc_tpu_torch.tools.vlad_near_ties [--draws N] [--planted T]
"""

from __future__ import annotations

import argparse

import torch

from anyloc_tpu_torch.ops.kernels.vlad_kernel import hard_label_agreement, vlad_aggregate_fused
from anyloc_tpu_torch.tools._timing import card_line, require_card

B, N, D, C = 32, 484, 1536, 32


def run(draws: int = 16, planted: int = 0, seed: int = 1000) -> dict:
    dev = require_card("vlad_near_ties")
    out = {"card": card_line(), "draws": draws, "planted": planted, "ties": 0, "flips": 0,
           "costs": [], "min_cos": 1.0, "bit_equal": True}
    for i in range(draws):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        x = torch.randn((B, N, D), generator=g, device=dev)
        x = x / x.norm(dim=-1, keepdim=True)
        centers = x.reshape(-1, D)[torch.randperm(B * N, generator=g, device=dev)[:C]]
        if planted:
            pair = torch.randint(0, C, (B, planted, 2), generator=g, device=dev)
            tie = centers[pair[..., 0]] + centers[pair[..., 1]]
            x[:, :planted] = tie / tie.norm(dim=-1, keepdim=True)
        for dist_mode in ("cosine", "euclidean"):
            got = vlad_aggregate_fused(x, centers, dist_mode=dist_mode)
            again = vlad_aggregate_fused(x, centers, dist_mode=dist_mode)
            out["bit_equal"] &= torch.equal(got, again)
            raw, cos, flips, ties = hard_label_agreement(got, x, centers, dist_mode=dist_mode)
            out["ties"] += int(ties.sum())
            out["flips"] += int(flips.sum())
            out["min_cos"] = min(out["min_cos"], cos.min().item())
            out["costs"] += [(dist_mode, seed + i, int(f), r)
                             for f, r in zip(flips.tolist(), raw.tolist()) if f]
    return out


def summary(res: dict) -> str:
    costs = "; ".join(f"{m} draw {s}: {f} flip(s), {r:.7f}" for m, s, f, r in res["costs"])
    return (f"[{res['card']}] K1 near ties [{B},{N},{D}] C={C}, {res['draws']} draws x hard "
            f"cosine / euclidean, {res['planted']} planted ties an image: {res['flips']} label "
            f"flip(s) on {res['ties']} near ties; flipped images' cosine before the flips are "
            f"explained: {costs or 'none'}; min per-image cosine after them "
            f"{res['min_cos']:.7f}; two launches {'bit-equal' if res['bit_equal'] else 'DIFFER'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--planted", type=int, default=0)
    args = ap.parse_args(argv)
    print(summary(run(args.draws, args.planted)), flush=True)


if __name__ == "__main__":
    main()
