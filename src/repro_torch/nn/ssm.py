"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Chunked SSD: an intra-chunk quadratic term plus an inter-chunk state
recurrence, a Python loop over chunks.  The projections go through the
INT-FP-QSim ``qmatmul`` chokepoint (and so through the matmul kernels under
a fused policy); the state recurrence itself stays f32 ``torch.einsum`` (it
is not a GEMM, and no kernel is written for it).

Decode carries ``(conv, state)``: an SSM's cache is O(1) in sequence
length.  ``decode_step`` returns a new cache; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import Policy
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import RMSNormGated


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_channels)
    state: torch.Tensor  # (B, H, P, N) f32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``: max(x, 0) + log1p(e^-|x|).
    ``torch.nn.functional.softplus`` returns x itself above its threshold,
    which is another function there."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _segsum_exp(dA_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(cum_i - cum_j) for i >= j else 0.  dA_cum: (..., Q, H).

    Above the diagonal the differences are positive and their exp may be
    inf: those entries are selected away, never multiplied by a 0 mask
    (inf * 0 is NaN)."""
    ci = dA_cum[..., :, None, :]
    cj = dA_cum[..., None, :, :]
    q = dA_cum.shape[-2]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=dA_cum.device))
    return torch.where(tri[..., None], torch.exp(ci - cj),
                       torch.zeros((), dtype=dA_cum.dtype,
                                   device=dA_cum.device))


@dataclasses.dataclass(frozen=True)
class Mamba2:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "mamba"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_out(self) -> int:
        # [z, x, B, C, dt]
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_heads)

    def _in_proj(self):
        return Dense(self.d_model, self.proj_out,
                     param_dtype=self.param_dtype, dtype=self.dtype,
                     name=f"{self.name}/in_proj")

    def _out_proj(self):
        return Dense(self.d_inner, self.d_model,
                     param_dtype=self.param_dtype, dtype=self.dtype,
                     name=f"{self.name}/out_proj")

    def _norm(self):
        return RMSNormGated(self.d_inner, param_dtype=self.param_dtype,
                            dtype=self.dtype)

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        pdt = getattr(torch, self.param_dtype)
        H = self.n_heads
        conv_w = torch.randn((self.d_conv, self.conv_channels),
                             generator=gen, dtype=torch.float32,
                             device=device) * (self.d_conv ** -0.5)
        return {
            "in_proj": self._in_proj().init(gen, device),
            "out_proj": self._out_proj().init(gen, device),
            "conv_w": conv_w.to(pdt),
            "conv_b": torch.zeros((self.conv_channels,), dtype=pdt,
                                  device=device),
            "A_log": torch.log(torch.linspace(
                1.0, 16.0, H, dtype=torch.float32, device=device)).to(pdt),
            "D": torch.ones((H,), dtype=pdt, device=device),
            "dt_bias": torch.log(torch.expm1(torch.full(
                (H,), 0.01, dtype=torch.float32, device=device))).to(pdt),
            "norm": self._norm().init(gen, device),
        }

    # ------------------------------------------------------------ internals
    def _split_proj(self, zxbcdt):
        di = self.d_inner
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + self.conv_channels]
        dt = zxbcdt[..., di + self.conv_channels:]
        assert dt.shape[-1] == self.n_heads
        return z, xbc, dt

    def _conv(self, xbc, params):
        """Causal depthwise conv of width d_conv over (B, S, C), the taps
        added in the reference's order."""
        w = params["conv_w"].to(torch.float32)  # (K, C)
        S = xbc.shape[1]
        xp = F.pad(xbc.to(torch.float32), (0, 0, self.d_conv - 1, 0))
        out = 0
        for i in range(self.d_conv):
            out = out + xp[:, i:i + S, :] * w[i][None, None, :]
        return F.silu(out + params["conv_b"].to(torch.float32))

    def _ssd(self, x, dt, B_, C_, A, state0=None):
        """Chunked SSD. x: (B, S, H, P), dt: (B, S, H), B_ / C_: (B, S, G,
        N), A: (H,).  Returns (y (B, S, H, P), final_state (B, H, P, N)).

        S is zero-padded to a multiple of the chunk with dt = 0: a padded
        step decays by exp(0) = 1 and adds nothing, so the final state is
        that of the S real steps."""
        Bb, S, H, P = x.shape
        N = B_.shape[-1]
        Q = min(self.chunk, S)
        pad = (-S) % Q
        if pad:
            def zpad(a):
                return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
            x, dt, B_, C_ = zpad(x), zpad(dt), zpad(B_), zpad(C_)
        nc = (S + pad) // Q
        rep = H // B_.shape[-2]
        Bh = torch.repeat_interleave(B_, rep, dim=2)  # (B, S, H, N)
        Ch = torch.repeat_interleave(C_, rep, dim=2)

        f32 = torch.float32
        xc = x.reshape(Bb, nc, Q, H, P).to(f32)
        dtc = dt.reshape(Bb, nc, Q, H).to(f32)
        Bc = Bh.reshape(Bb, nc, Q, H, N).to(f32)
        Cc = Ch.reshape(Bb, nc, Q, H, N).to(f32)

        torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        dA = dtc * A[None, None, None, :]  # (B, nc, Q, H)
        cs = torch.cumsum(dA, dim=2)
        L = _segsum_exp(cs)  # (B, nc, Q, Q, H)
        scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
        xdt = xc * dtc[..., None]  # (B, nc, Q, H, P)
        y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores * L, xdt)

        # chunk states: sum_j B_j (x) xdt_j * exp(cs_last - cs_j)
        decay_out = torch.exp(cs[:, :, -1:, :] - cs)  # (B, nc, Q, H)
        chunk_state = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bc, xdt,
                                   decay_out)
        chunk_decay = torch.exp(cs[:, :, -1, :])  # (B, nc, H)

        s = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
             if state0 is None else state0.to(f32))
        prev = []  # the state *before* each chunk
        for c in range(nc):
            prev.append(s)
            s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
        prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)
        y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc, prev_states,
                               torch.exp(cs))
        y = (y_intra + y_inter).reshape(Bb, S + pad, H, P)
        if pad:
            y = y[:, :S]
        return y, s

    # ------------------------------------------------------------- forward
    def apply(self, params: dict, x: torch.Tensor, policy: Policy,
              q: dict | None = None, return_cache: bool = False):
        """(B, S, d_model) -> (B, S, d_model), and with ``return_cache``
        the decode cache after the S steps.  ``q``: static-scale slice
        ``{"in_proj": ..., "out_proj": ...}``."""
        B, S, _ = x.shape
        H, P = self.n_heads, self.head_dim
        GN = self.n_groups * self.d_state
        getq = (lambda k: None) if q is None else q.get
        zxbcdt = self._in_proj().apply(params["in_proj"], x, policy,
                                       q=getq("in_proj"))
        z, xbc_raw, dt = self._split_proj(zxbcdt)
        xbc = self._conv(xbc_raw, params)
        di = self.d_inner
        xs = xbc[..., :di].reshape(B, S, H, P)
        B_ = xbc[..., di:di + GN].reshape(B, S, self.n_groups, self.d_state)
        C_ = xbc[..., di + GN:].reshape(B, S, self.n_groups, self.d_state)
        dt = softplus(dt.to(torch.float32)
                      + params["dt_bias"].to(torch.float32))
        A = -torch.exp(params["A_log"].to(torch.float32))
        y, final_state = self._ssd(xs, dt, B_, C_, A)
        y = y + params["D"].to(torch.float32)[None, None, :, None] * xs
        y = self._norm().apply(params["norm"], y.reshape(B, S, di), z)
        out = self._out_proj().apply(params["out_proj"], y, policy,
                                     q=getq("out_proj"))
        if not return_cache:
            return out
        kc = self.d_conv - 1
        tail = (xbc_raw[:, -kc:, :] if S >= kc
                else F.pad(xbc_raw, (0, 0, kc - S, 0)))
        return out, SSMCache(conv=tail.to(getattr(torch, self.dtype)),
                             state=final_state)

    # -------------------------------------------------------------- decode
    def init_cache(self, batch: int, dtype=None, device="cuda") -> SSMCache:
        dt = dtype or getattr(torch, self.dtype)
        return SSMCache(
            conv=torch.zeros((batch, self.d_conv - 1, self.conv_channels),
                             dtype=dt, device=device),
            state=torch.zeros((batch, self.n_heads, self.head_dim,
                               self.d_state), dtype=torch.float32,
                              device=device))

    def _conv_step(self, conv, xbc, params):
        """The conv over the cached window and this step's (B, 1, C)
        channels: (silu'd output (B, 1, C), the next window)."""
        f32 = torch.float32
        win = torch.cat([conv.to(f32), xbc.to(f32)], dim=1)
        out = ((win * params["conv_w"].to(f32)[None]).sum(dim=1)
               + params["conv_b"].to(f32))
        return F.silu(out)[:, None, :], win[:, 1:, :].to(conv.dtype)

    def _state_step(self, state, xs, dtv, B_, C_, A):
        """One step of the recurrence: xs (B, H, P), dtv (B, H), B_ / C_
        (B, G, N) -> (y (B, H, P), the next state (B, H, P, N))."""
        f32 = torch.float32
        H, G = self.n_heads, self.n_groups
        Bh = torch.repeat_interleave(B_, H // G, dim=1)  # (B, H, N)
        Ch = torch.repeat_interleave(C_, H // G, dim=1)
        decay = torch.exp(dtv * A[None, :])  # (B, H)
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        state = state.to(f32) * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtv, xs.to(f32), Bh)
        return torch.einsum("bhpn,bhn->bhp", state, Ch), state

    def decode_step(self, params: dict, x: torch.Tensor, cache: SSMCache, *,
                    policy: Policy, q: dict | None = None
                    ) -> tuple[torch.Tensor, SSMCache]:
        """x: (B, 1, d_model) -> (y (B, 1, d_model), the next cache)."""
        B = x.shape[0]
        H, P, G, N = self.n_heads, self.head_dim, self.n_groups, self.d_state
        getq = (lambda k: None) if q is None else q.get
        f32 = torch.float32
        zxbcdt = self._in_proj().apply(params["in_proj"], x, policy,
                                       q=getq("in_proj"))
        z, xbc, dt = self._split_proj(zxbcdt)  # (B, 1, *)
        xbc_t, new_conv = self._conv_step(cache.conv, xbc, params)
        di = self.d_inner
        xs = xbc_t[..., :di].reshape(B, H, P)
        B_ = xbc_t[..., di:di + G * N].reshape(B, G, N)
        C_ = xbc_t[..., di + G * N:].reshape(B, G, N)
        dtv = softplus(dt[:, 0, :].to(f32) + params["dt_bias"].to(f32))
        A = -torch.exp(params["A_log"].to(f32))
        y, state = self._state_step(cache.state, xs, dtv, B_, C_, A)
        y = y + params["D"].to(f32)[None, :, None] * xs
        y = self._norm().apply(params["norm"], y.reshape(B, 1, di), z)
        out = self._out_proj().apply(params["out_proj"], y, policy,
                                     q=getq("out_proj"))
        return out, SSMCache(conv=new_conv, state=state)

def mamba_from_config(cfg, name: str = "mamba") -> Mamba2:
    """The Mamba2 block of an SSM or hybrid ``ArchConfig``."""
    return Mamba2(d_model=cfg.d_model, d_state=cfg.ssm_state,
                  d_conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                  head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
                  chunk=cfg.ssm_chunk, param_dtype=cfg.param_dtype,
                  dtype=cfg.dtype, name=name)
