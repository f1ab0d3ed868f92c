"""Time one tree's float32 training kernels, for an A/B of two commits on one card.

    python3 -m self_attention_tacotron_torch.tools.ab_training_kernels TREE LABEL

TREE is a checkout: this tree (``.``), or the parent commit's package unpacked
with ``git archive`` into the git-ignored ``runs/parent``. That tree's own package
is imported and builds its own kernels into its own ``build/``, so both trees'
kernels run in one process each, on one card. It times, by CUDA events, the
teacher-forced decoder kernels (``fused_teacher``, forward and backward, float32,
the flagship's widths from seeded weights, B=32, S=128 ragged, N=400, train
zoneout and prenet dropout; five launches each after a warm-up) and the BiGRU
backward's carry kernel (``bigru_bwd``, float32, B=32, S=128, H=128; five runs of
20 launches), and prints one ``AB {...}`` JSON line with the card's name and power
limit. Run it in turns (parent, change, change, parent) in one chip call:

    for t in runs/parent:parent .:change .:change runs/parent:parent; do
      python3 -m self_attention_tacotron_torch.tools.ab_training_kernels "${t%%:*}" "${t##*:}"
    done

Needs a CUDA device; the tree must have ``self_attention_tacotron_torch/ops``.
"""
import json
import os
import subprocess
import sys

import numpy as np


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    tree, label = os.path.abspath(args[0]), args[1]
    sys.path.insert(0, tree)
    import torch
    from self_attention_tacotron_torch.ops import fused_rnn, fused_teacher

    assert fused_teacher.__file__.startswith(tree), fused_teacher.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    arr = lambda *shape, scale=0.3: torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(scale), device=dev)
    B, S, N = 32, 128, 400
    z = dict(F=80, P1=256, P2=128, AU=256, A1=224, A2=32, DU=256, E1=256, E2=256)
    A, E = z["A1"] + z["A2"], z["E1"] + z["E2"]
    in_att, in1 = z["P2"] + E + z["AU"], z["AU"] + E + z["DU"]
    fan = lambda k: 1.0 / np.sqrt(k)
    vblk = torch.zeros(A, 2, device=dev); vblk[: z["A1"], 0] = arr(z["A1"]); vblk[z["A1"]:, 1] = arr(z["A2"])
    w = dict(w_p1=arr(z["F"], z["P1"]), b_p1=arr(z["P1"]), w_p2=arr(z["P1"], z["P2"], scale=fan(z["P1"])), b_p2=arr(z["P2"]),
             w_attg=arr(in_att, 4 * z["AU"], scale=fan(in_att)), b_attg=arr(4 * z["AU"]), w_qp=arr(z["AU"], A, scale=fan(z["AU"])),
             vblk=vblk, w_ta=arr(z["E1"] + z["AU"], 1, scale=fan(z["AU"])), b_ta=arr(1),
             w_l1=arr(in1, 4 * z["DU"], scale=fan(in1)), b_l1=arr(4 * z["DU"]), w_l2=arr(2 * z["DU"], 4 * z["DU"], scale=fan(2 * z["DU"])), b_l2=arr(4 * z["DU"]))
    lengths = np.clip(rng.integers(24, 129, B), 24, 128); lengths[0] = 128
    lens = torch.tensor(lengths, device=dev)
    ops = dict(keys=arr(B, S, A), mem1=arr(B, S, z["E1"]), mem2=arr(B, S, z["E2"]), spk=None,
               score_bias=torch.where(torch.arange(S, device=dev)[None] < lens[:, None], 0.0, -1e9).float(),
               hp_like=dict(dual=True, use_ta=False, att_units=z["AU"], att1_units=z["A1"], att2_units=z["A2"], dec_units=z["DU"],
                            zoneout_cell=0.1, zoneout_output=0.1, prenet_drop_rate=0.5, io_dtype="float32", src1_kind="forward", eval_zoneout=False))
    feeds = arr(B, N, z["F"])
    masks = tuple(torch.tensor(rng.random((B, N, u)) < 0.5, device=dev) for u in (z["P1"], z["P2"]))
    cot = arr(B, N, z["DU"], scale=1.0)
    fwd, bwd = [], []
    for i in range(6):
        wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
        feat, _ = fused_teacher.teacher_decode(weights=wl, feeds=feeds, seed=1234, prenet_masks=masks, **ops)
        (feat * cot).sum().backward()
        if i:
            fwd.append(fused_teacher.last_launch_ms("fwd")); bwd.append(fused_teacher.last_launch_ms("bwd"))
    # bigru_bwd's carry kernel at B=32 S=128 H=128
    C = H = 128
    xs = arr(B, S, C, scale=1.0)
    params = [{"gates_kernel": arr(C + H, 2 * H, scale=fan(C + H)), "gates_bias": arr(2 * H, scale=0.1),
               "candidate_kernel": arr(C + H, H, scale=fan(C + H)), "candidate_bias": arr(H, scale=0.1)} for _ in range(2)]
    weights = [p[k] for p in params for k in fused_rnn._PARAM_KEYS]
    y = fused_rnn.bigru(xs, lens, params[0], params[1], H)
    rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(xs, y, weights, H)
    g_y = arr(B, S, 2 * H, scale=1.0)
    carry = []
    for i in range(6):
        torch.cuda.synchronize()
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        for _ in range(20):
            fused_rnn.bigru_bwd_carry(g_y, rz, n, hp, lens, wgh_t, wch_t)
        s1.record(); torch.cuda.synchronize()
        if i:
            carry.append(s0.elapsed_time(s1) / 20)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print("AB " + json.dumps({"tree": label, "card": card, "teacher_fwd_ms": fwd, "teacher_bwd_ms": bwd, "bigru_bwd_ms": carry,
                              "median": {"fwd": float(np.median(fwd)), "bwd": float(np.median(bwd)), "bigru_bwd": float(np.median(carry))}}), flush=True)


if __name__ == "__main__":
    main()
