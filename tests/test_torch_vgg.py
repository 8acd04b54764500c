"""VGG-19 with batch norm (``benchmarks/run.py``'s ``vgg`` row) in the port
against the JAX package, on the CPU, at the book test's size (batch 4,
32x32, 4 classes, f32, Momentum at 0.01), with the ``dropout_prob`` attrs
set to 0 in both built programs; the helpers are
``test_torch_zoo_models.py``'s."""

import numpy as np

from test_torch_zoo_models import FWD_TOL, GRAD_TOL, _hold_dead, _runs


def test_vgg19_three_steps_within_the_references_own_spread():
    """VGG-19 with batch norm at batch 4 and 32x32 (its last stages are
    2x2 and 1x1, normalised over 4 values) is chaotic at random init in
    f32: a one-ulp move of its weights changes the reference's own
    gradients of single parameters by up to 13%.  As for ResNet-50
    (``tests/test_torch_resnet.py``), the step is compared whole against
    the spread of the reference's runs from its state moved one ulp up
    and down: each loss, the first step's gradient vector (relative L2,
    and a cosine of at least 0.999) and the update of the parameters
    over three steps (relative L2), each within ORACLE_TOL or twice that
    spread, whichever is larger; the dead conv biases as
    ``_hold_dead``."""
    got, refs, params, dead = _runs("vgg", bumps=(0, 1, -1))
    ref = refs[0]
    live = [i for i, p in enumerate(params) if p not in dead]

    def spread(fn):
        return max(fn(r) for r in refs[1:])

    for k in range(3):
        loss = float(ref["steps"][k][0][0])
        own = spread(lambda r: abs(float(r["steps"][k][0][0]) - loss))
        assert abs(float(got["steps"][k][0][0]) - loss) <= max(
            FWD_TOL * abs(loss), 2 * own), k

    def flat(run, k=0):
        return np.concatenate([run["steps"][k][1 + i].ravel() for i in live])

    g_ref = flat(ref)

    def l2(run):
        return float(np.linalg.norm(flat(run) - g_ref)
                     / np.linalg.norm(g_ref))

    assert l2(got) <= max(GRAD_TOL, 2 * spread(l2)), (l2(got), spread(l2))
    g_got = flat(got)
    assert g_got @ g_ref / np.linalg.norm(g_got) / np.linalg.norm(
        g_ref) >= 0.999

    def moved(run):
        return np.concatenate([(run["state"][params[i]]
                                - run["init"][params[i]]).ravel()
                               for i in live])

    d_ref = moved(ref)

    def upd(run):
        return float(np.linalg.norm(moved(run) - d_ref)
                     / np.linalg.norm(d_ref))

    assert upd(got) <= max(GRAD_TOL, 2 * spread(upd)), (upd(got),
                                                        spread(upd))
    _hold_dead(got, ref, params, dead)
