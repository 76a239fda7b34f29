"""How often a decode call's probs-QDQ codes differ from the plain
version's, for four ways of forming the softmax denominator l, on the card.

The long path's decode call (B = 4, S = 1, T = 8192, H = 28, KV = 4, D =
128, phased, bk = 512, n = 64; rows at 6007, 4107, 2507 keys and a dead
row) on ``--trials`` random inputs of ``chip_smoke.attention_inputs``, int8
and fp8 codes.  The scores, their exact row maximum m and e = exp(s - m)
are the plain version's on the card (``flash_attention_quant_plain``'s
einsum); only l changes, in torch on the card.  Two plain versions, both
the reference's phased recurrence over bk tiles in f32: with each tile's
sum as torch's f32 reduction orders it, and with each tile's sum the f32
nearest its f64 value (the plain version's l).  The ways:

  fold64     (m, l) folded per 64-key tile in f32 over each of 8 blocks'
             contiguous range, merged as l_c exp(m_c - m) in block order
             (``attention_long_kernel``'s statistics)
  sum_f32    e with the exact m, f32 lane sums (lane l adds keys l, l +
             32, ..., then a butterfly), blocks added in order
  sum_f64    the same sums in f64, rounded once (one sum of the row)
  bk_f64     the recurrence over bk tiles, each tile's sum in f64
             rounded once (``attention_decode_long_kernel``'s)

Prints, for each, the live rows (batch row x head) with a probs-QDQ code
other than each plain version's, and those whose l has other bits than
the recurrence's; then, at S = 1 and S = 64, how many scores of a library
product (``einsum``, the plain version's scores before it formed them as
the kernels' chain) differ from the ``fmaf`` chain.  One such row moves 128 outputs by a QDQ step times V;
at near-uniform attention (fp8 codes at these scales) that shows against
the tight part of ``chip_smoke.check_attention``'s bar.

    python3 scripts/attention_probs_flips.py [--trials 6]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=6)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.core.quantize import div_by_constant

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = "cuda"
    B, H, KV, D, T, bk, n, C = 4, 28, 4, 128, 8192, 512, 64, 8
    G = H // KV

    def qdq(p):
        pg = p.reshape(*p.shape[:-1], -1, n)
        a = pg.amax(-1, keepdim=True).to(torch.bfloat16).float()
        st = div_by_constant(a.clamp_min(1e-12), 127.0)
        return (torch.clamp(torch.round(pg / st), -127, 127) * st).reshape(
            p.shape)

    def lane_sum(e, dtype):
        lanes = e.to(dtype).reshape(*e.shape[:-1], -1, 32)
        v = torch.zeros(*e.shape[:-1], 32, device=dev, dtype=dtype)
        for i in range(lanes.shape[-2]):
            v = v + lanes[..., i, :]
        idx = torch.arange(32, device=dev)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., idx ^ o]
        return v[..., 0]

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {}
    for fp8 in (True, False):
        names = ("fold64", "sum_f32", "sum_f64", "bk_f64")
        flipped = dict.fromkeys(names, 0)
        flipped64 = dict.fromkeys(names, 0)
        other_l = dict.fromkeys(names, 0)
        rows = 0
        for _ in range(args.trials):
            qh, kc, _, ks, _, q_pos, kv_pos = cs.attention_inputs(
                torch, gen, B=B, S=1, T=T, H=H, KV=KV, D=D, fp8=fp8,
                q_starts=[6007, 4107, 2507, -1])
            k = kc.float() * ks[..., None]
            s = torch.einsum("bskgd,btkd->bkgst", qh.reshape(B, 1, KV, G, D),
                             k) * D ** -0.5
            mask = (kv_pos[:, None] >= 0) & (kv_pos[:, None] <= q_pos[:, :,
                                                                      None])
            s = torch.where(mask[:, None, None], s,
                            torch.full_like(s, -1e9))[:, :, :, 0]
            m = torch.full(s.shape[:-1] + (1,), -1e30, device=dev)
            l = torch.zeros_like(m)
            for t0 in range(0, T, bk):
                st = s[..., t0:t0 + bk]
                mn = torch.maximum(m, st.amax(-1, keepdim=True))
                l = l * torch.exp(m - mn) + torch.exp(st - mn).sum(
                    -1, keepdim=True)
                m = mn
            e = torch.exp(s - m)
            want = qdq(e / l)
            m64 = torch.full_like(m, -1e30)
            l64 = torch.zeros_like(m)
            for t0 in range(0, T, bk):
                st = s[..., t0:t0 + bk]
                mn = torch.maximum(m64, st.amax(-1, keepdim=True))
                l64 = l64 * torch.exp(m64 - mn) + torch.exp(
                    st - mn).double().sum(-1, keepdim=True).float()
                m64 = mn
            want64 = qdq(e / l64)
            for b in range(3):
                nctx = int((kv_pos[b] >= 0).sum())
                units = -(-nctx // 64)
                ranges = [(c * units // C * 64, (c + 1) * units // C * 64)
                          for c in range(C)]
                sb, eb, lp = s[b], e[b], l[b, ..., 0]
                got = {}
                stats = []
                for a, z in ranges:
                    mm = torch.full((KV, G), -1e30, device=dev)
                    ll = torch.zeros(KV, G, device=dev)
                    for t0 in range(a, z, 64):
                        st = sb[..., t0:t0 + 64]
                        mu = st.amax(-1)
                        sg = lane_sum(torch.exp(st - mu[..., None]),
                                      torch.float32)
                        mn = torch.maximum(mm, mu)
                        ll = ll * torch.exp(mm - mn) + sg * torch.exp(mu - mn)
                        mm = mn
                    stats.append((mm, ll))
                mx = torch.stack([mm for mm, _ in stats]).amax(0)
                got["fold64"] = sum(ll * torch.exp(mm - mx)
                                    for mm, ll in stats)
                for name, dt in (("sum_f32", torch.float32),
                                 ("sum_f64", torch.float64)):
                    acc = torch.zeros(KV, G, device=dev, dtype=dt)
                    for a, z in ranges:
                        if z > a:
                            acc = acc + lane_sum(eb[..., a:z], dt)
                    got[name] = acc.float()
                mb = torch.full((KV, G), -1e30, device=dev)
                lb = torch.zeros(KV, G, device=dev)
                for t0 in range(0, T, bk):
                    st = sb[..., t0:t0 + bk]
                    mn = torch.maximum(mb, st.amax(-1))
                    lb = lb * torch.exp(mb - mn) + torch.exp(
                        st - mn[..., None]).double().sum(-1).float()
                    mb = mn
                got["bk_f64"] = lb
                for name, lx in got.items():
                    px = qdq(eb / lx[..., None])
                    flipped[name] += int((px[..., :nctx] != want[b][
                        ..., :nctx]).any(-1).sum())
                    flipped64[name] += int((px[..., :nctx] != want64[b][
                        ..., :nctx]).any(-1).sum())
                    other_l[name] += int((lx != lp).sum())
                rows += KV * G
        out["fp8" if fp8 else "int8"] = {
            "live_rows": rows, "rows_with_a_flipped_code": flipped,
            "against_the_plain_version": flipped64,
            "rows_whose_l_differs": other_l}
    # the plain version's scores before it formed them as the kernels'
    # chain: a library product (einsum) against fmaf over d = 0 .. D - 1
    # from 0 (emulated in f64, rounded per step), at S = 1 and S = 64
    differ = {}
    for S in (1, 64):
        qh, kc, _, ks, *_ = cs.attention_inputs(
            torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D, fp8=False,
            q_starts=[6007, 4107, 2507, -1])
        k = kc.float() * ks[..., None]
        qg = qh.reshape(B, S, KV, G, D)
        lib = torch.cat([torch.einsum("bskgd,btkd->bkgst", qg,
                                      k[:, t0:t0 + bk])
                         for t0 in range(0, T, bk)], -1)
        q5 = qg.permute(0, 2, 3, 1, 4).double()
        k4 = k.permute(0, 2, 1, 3).double()
        chain = torch.zeros_like(lib)
        for d in range(D):
            chain = (q5[..., d, None] * k4[:, :, None, None, :, d]
                     + chain.double()).float()
        differ[f"S={S}"] = [int((lib != chain).sum()), lib.numel()]
    out["einsum_scores_off_the_chain"] = differ
    print(json.dumps(out), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
