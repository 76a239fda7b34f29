"""QL3xx: kernel/launch feasibility — int32 accumulator bounds, block
divisibility, the Hopper kernels' shared-memory plans — all computed from
shapes, never traced and never launched.

Message text is shared with the runtime typed errors (see
``analysis.messages``): hitting the runtime exception and reading the lint
finding should feel like the same diagnosis.  QL303 goes further: it asks
the kernels' own plans (``plan_abfp_matmul``, ``quant_matmul_plan``), so
the finding is the very ``ValueError`` the wrapper would raise before its
launch.
"""

from __future__ import annotations

from repro_torch.analysis import messages as msg
from repro_torch.analysis.backend_lint import (
    _Dedup,
    symbolic_backend,
    weight_compressible,
)
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import Policy, QuantPolicy, resolve_policy
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels.ops import SMEM_MAX

# Rows a fused matmul is planned for when no shape is given: a decode
# step, the 16-row verify / decode regime, and a paged prefill chunk.
PLAN_ROWS = (1, 16, 256)


def _int_accum_spec(pol: QuantPolicy, K: int, *,
                    compressed_storage: bool):
    """(n_contracted, qmax_x, qmax_w) of the active int32-accumulation
    path at a site, or None when accumulation stays float.

    int32 paths: the int8 backend, the fused kernel under compute='int8',
    and the compressed backend's aligned fast path (int-ABFP input whose
    group matches the stored grouping).
    """
    tin, tw = pol.input, pol.weight
    backend = symbolic_backend(pol, compressed_storage=compressed_storage)
    if backend == "compressed":
        if tw is None or not isinstance(tw.fmt, IntFormat):
            return None
        stored_group = tw.group if tw.scaler == "abfp" else K
        if (tin is not None and isinstance(tin.fmt, IntFormat)
                and tin.scaler == "abfp" and tin.group == stored_group):
            return (min(stored_group, K), tin.fmt.qmax_pos, tw.fmt.qmax_pos)
        return None  # misaligned inputs take the f32 grouped path
    if backend == "int8" or (backend == "fused" and pol.compute == "int8"):
        if tin is None or tw is None:
            return None
        if not (isinstance(tin.fmt, IntFormat)
                and isinstance(tw.fmt, IntFormat)):
            return None
        return (min(tin.group, K), tin.fmt.qmax_pos, tw.fmt.qmax_pos)
    return None


def plan_rows(cfg, shape) -> tuple:
    """The rows (M) of the matmul calls a launch makes: with a shape, the
    global batch times the sequence (train / prefill; a ViT's image grid)
    or the global batch (decode); without one, ``PLAN_ROWS``."""
    if shape is None:
        return PLAN_ROWS
    if shape.kind == "decode":
        return (shape.global_batch,)
    seq = cfg.vit_seq_len if cfg.family == "vit" else shape.seq_len
    return (shape.global_batch * seq,)


def plan_refusal(pol: QuantPolicy, K: int, N: int, stored: bool,
                 rows) -> str | None:
    """The ``ValueError`` text with which the kernel a site launches would
    refuse a (M, K) x (K, N) call, for the first M of ``rows`` it refuses;
    None where every M plans (or the site launches no matmul kernel).

    A dense fused site launches ``abfp_matmul`` (``abfp_matmul_int8``
    under compute='int8'), planned by ``plan_abfp_matmul``; a compressed
    site under a fused policy whose int-ABFP input matches the stored
    grouping launches ``quant_matmul``, planned by ``quant_matmul_plan``
    on the stored (padded) codes.  Sites that QL206 / QL302 already block
    are not planned.
    """
    tin, tw = pol.input, pol.weight
    if not (pol.enabled and pol.fused and tin is not None
            and tw is not None):
        return None
    if stored:
        n = tw.group if tw.scaler == "abfp" else K
        if not (isinstance(tin.fmt, IntFormat) and tin.scaler == "abfp"
                and tin.group == n):
            return None  # the compressed backend's plain contraction

        def plan(M):
            qm.quant_matmul_plan(M, N, -(-K // n) * n, n,
                                 tw.fmt.bits <= 4 and n % 2 == 0)
    else:
        n = tin.group
        if K % n:
            return None  # QL302

        def plan(M):
            qm.plan_abfp_matmul(M, N, K, n, int8=pol.compute == "int8",
                                formats=(tin.fmt, tw.fmt))
    for M in rows:
        try:
            plan(M)
        except ValueError as e:
            return str(e)
    return None


def lint_kernels(cfg, policy: Policy, sites, *, compress: bool,
                 shape=None) -> list:
    """QL301-QL304 over the model's matmul + attention sites."""
    dd = _Dedup()
    for site, K, N, mult in sites:
        pol = resolve_policy(policy, site)
        stored = compress and weight_compressible(pol.weight)

        spec = _int_accum_spec(pol, K, compressed_storage=stored)
        if spec is not None:
            n_acc, qx, qw = spec
            bound = int(n_acc * qx * qw)
            if bound > msg.INT32_MAX:
                dd.add(
                    "QL301", site, pol.name,
                    msg.int32_overflow_message(
                        site, K, n_acc, int(qx).bit_length() + 1,
                        int(qw).bit_length() + 1, bound),
                    hint="shrink the ABFP group (channel_max spans all "
                         "of K), or use the fp-accumulation ref backend",
                )

        backend = symbolic_backend(pol, compressed_storage=stored)
        if backend == "fused" and pol.input is not None:
            n = pol.input.group
            if K % n:
                # the fused wrappers raise exactly this
                dd.add(
                    "QL302", site, pol.name,
                    msg.abfp_group_message(K, n, where=site),
                    hint="pick a group length dividing K (the non-fused "
                         "backends zero-pad instead)",
                )
        refusal = plan_refusal(pol, K, N, stored, plan_rows(cfg, shape))
        if refusal is not None:
            dd.add(
                "QL303", site, pol.name, refusal,
                hint="shrink the ABFP group (a block may use "
                     f"{SMEM_MAX} bytes of shared memory); the kernel's "
                     "plan refuses this call before any launch",
            )

    # attention sequence-vs-block tiling (flash/blockwise runtime assert)
    if shape is not None and shape.kind in ("train", "prefill") \
            and not getattr(cfg, "is_attention_free", False):
        S = cfg.vit_seq_len if cfg.family == "vit" else shape.seq_len
        qb = min(cfg.q_block, S)
        kb = min(cfg.kv_block, S)
        if S % qb or S % kb:
            dd.out.append(_attention_diag(S, S, qb, kb))
    return dd.out


def lint_pages(geo) -> list:
    """QL305-QL307 over a paged-serving geometry.

    ``geo`` is a ``serve.kv_pages.PageGeometry`` (duck-typed: page_size /
    n_pages / max_len / prefill_chunk / max_pages_per_seq).  The two error
    codes mirror ``kv_pages.check_geometry`` word for word — the pre-flight
    gate and the runtime constructor tell the same story; QL307 is the
    advisory the runtime never raises (coarse pages are legal, just
    wasteful: admission reserves whole pages, so up to ``page_size - 1``
    tokens of the worst-case reservation are rounding).
    """
    from repro_torch.analysis.diagnostics import Diagnostic

    out = []
    if geo.prefill_chunk % geo.page_size:
        out.append(Diagnostic(
            code="QL306", site="serve/pages",
            message=msg.page_chunk_message(geo.prefill_chunk, geo.page_size),
            hint="pick prefill_chunk as a multiple of page_size",
        ))
    if geo.n_pages < geo.max_pages_per_seq:
        out.append(Diagnostic(
            code="QL305", site="serve/pages",
            message=msg.page_pool_message(
                geo.n_pages, geo.max_pages_per_seq, geo.max_len,
                geo.page_size),
            hint="grow n_pages to at least pages_for(max_len, page_size) "
                 "or lower max_len",
        ))
    if geo.max_len > 0 and geo.page_size > max(geo.max_len // 4, 1):
        waste_pct = 100.0 * (geo.page_size - 1) / geo.max_len
        out.append(Diagnostic(
            code="QL307", site="serve/pages",
            message=msg.page_waste_message(geo.page_size, geo.max_len,
                                           waste_pct),
            hint="shrink page_size (finer pages round-off less of the "
                 "per-request reservation)",
        ))
    return out


def _attention_diag(S: int, T: int, bq: int, bk: int):
    from repro_torch.analysis.diagnostics import Diagnostic

    return Diagnostic(
        code="QL304",
        site="*/attn",
        message=msg.attention_block_message(S, T, bq, bk),
        hint="pad the sequence or set q_block/kv_block to divisors of it",
    )
