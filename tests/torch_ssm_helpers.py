"""What the SSM and hybrid parity tests of the port share: the logits bar
under quantized policies, a count of the matmul wrappers' calls, and a
parameter tree's shapes."""

import numpy as np

from repro_torch.kernels import quant_matmul as t_qm

FP32 = dict(rtol=1e-5, atol=1e-5)  # f32 logits summed in another order
# Under a quantized policy the stacks' RMSNorms round their f32 mean and
# rsqrt differently in the last bit, which moves a few int8 activation codes
# across a rounding boundary (each Mamba2 block alone agrees given the same
# input): the logits are held to this share of the root mean square by which
# QDQ itself moves them, measured at under 1.5 % on the reduced configs.
QDQ_SHARE = 0.03


def held(got, want, no_qdq, policy):
    """``got`` (the port's logits) against ``want`` (the reference's): fp32
    within FP32; a quantized policy within QDQ_SHARE of the rms of
    ``no_qdq - want`` (``no_qdq``: the reference's fp32 logits)."""
    got = got.detach().numpy()
    want = np.asarray(want)
    if policy == "fp32":
        np.testing.assert_allclose(got, want, **FP32)
        return
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    gap, qdq = rms(got - want), rms(np.asarray(no_qdq) - want)
    assert qdq > 0.01 and gap <= QDQ_SHARE * qdq, (gap, qdq)


class Calls:
    """Calls of the matmul wrappers the model makes (on the CPU each runs
    its plain version)."""

    NAMES = ("abfp_matmul", "abfp_matmul_int8", "quant_matmul")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = getattr(t_qm, name)
            monkeypatch.setattr(t_qm, name, self._counted(name, fn))

    def _counted(self, name, fn):
        def call(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return call


def shapes(tree):
    """The shapes of a tree of tensors, in its nesting."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes(v) for v in tree]
    return tuple(tree.shape)
