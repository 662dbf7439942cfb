"""The fused MLP over G weight sets (ops/fused_mlp.py: ``plain_mlp_grouped``,
``fused_mlp_grouped``, the grouped operator and the vmap rule of
``rl_games_tpu_torch::fused_mlp``) on the CPU.

- ``plain_mlp_grouped`` against a loop of ``plain_mlp`` over the sets, for
  every mix of x, weights and biases with the set axis or shared.
- ``torch.func.vmap`` of ``fused_mlp`` and of a ``FusedMLP`` through
  ``functional_call`` over stacked ``state_dict``s, with grad off and on:
  outputs and gradients against the loop at rtol = atol = 1e-6 (the same
  float32 chain, products taken batched); a vmap over x alone folds into one
  ordinary call, bit for bit.
- ``fused_mlp_grouped_cuda``'s refusals (it launches only on a card; the
  card's run is ``chip_smoke.py``'s [kernels] phase).
- ``jax.vmap`` of the JAX package's ``fused_mlp`` over per-set weights (its
  CPU route, ``plain_mlp``) against the port's vmapped operator, at
  rtol = atol = 1e-5.

Weights are carried across transposed: the JAX package keeps [in, out]
kernels, ``torch.nn.Linear`` [out, in].
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.ops import fused_mlp as jfm
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)

G, B, DIMS = 4, 3, (5, 7, 3)
TOL = dict(rtol=1e-6, atol=1e-6)


def sets(seed, dims=DIMS, groups=G, batch=B):
    """x [G, B, D_0], weights [G, out, in], biases [G, out] from one numpy
    seed, at the init's scale."""
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(-1, 1, (groups, dims[i + 1], dims[i])) / np.sqrt(dims[i]) for i in range(len(dims) - 1)]
    bs = [rng.normal(size=(groups, dims[i + 1])) * 0.1 for i in range(len(dims) - 1)]
    x = rng.normal(size=(groups, batch, dims[0]))
    return [torch.tensor(a, dtype=torch.float32) for a in (x, *ws, *bs)]


def loop(x, ws, bs, activation, batched):
    """plain_mlp set by set; ``batched`` says, per tensor of (x, *ws, *bs),
    whether it has the set axis."""
    n = len(ws)
    out = []
    for g in range(G):
        picked = [t[g] if b else t for t, b in zip((x, *ws, *bs), batched)]
        out.append(fm.plain_mlp(picked[0], picked[1:1 + n], picked[1 + n:], activation))
    return torch.stack(out)


def shared(tensors, batched):
    """The tensors of a mix: set 0's for those without the set axis."""
    return [t if b else t[0] for t, b in zip(tensors, batched)]


# every mix of x, the two weights and the two biases with the set axis or
# shared, but all shared (no set axis: the ordinary chain)
MIXES = [m for m in itertools.product((True, False), repeat=5) if any(m)]
MIX_IDS = ["".join("s" if b else "-" for b in m) for m in MIXES]


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh"])
@pytest.mark.parametrize("batched", MIXES, ids=MIX_IDS)
def test_plain_grouped_matches_loop(batched, activation):
    tensors = shared(sets(0), batched)
    got = fm.plain_mlp_grouped(tensors[0], tensors[1:3], tensors[3:], activation)
    assert got.shape == (G, B, DIMS[-1])
    torch.testing.assert_close(got, loop(tensors[0], tensors[1:3], tensors[3:], activation, batched), **TOL)


def vmapped_chain(batched, activation, in_dim=0):
    """torch.func.vmap of fused_mlp with the mix's in_dims."""
    dims = [in_dim if b else None for b in batched]
    return torch.func.vmap(lambda x, ws, bs: fm.fused_mlp(x, ws, bs, activation),
                           in_dims=(dims[0], dims[1:3], dims[3:]))


# all batched; x shared; a weight shared; a bias shared; x alone (folded)
VMAP_MIXES = [(True,) * 5, (False, True, True, True, True), (True, False, True, True, True),
              (True, True, True, True, False), (True, False, False, False, False)]


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("batched", VMAP_MIXES, ids=["all", "x_shared", "w0_shared", "b1_shared", "x_only"])
def test_vmap_of_fused_mlp_matches_loop(batched, grad):
    """Outputs, and with grad the gradients of every input (the operator's
    backward through ``plain_mlp_grouped`` or ``plain_mlp``), against the
    loop's."""
    tensors = [t.requires_grad_(grad) for t in shared(sets(1), batched)]
    with torch.set_grad_enabled(grad):
        got = vmapped_chain(batched, "elu")(tensors[0], tensors[1:3], tensors[3:])
        want = loop(tensors[0], tensors[1:3], tensors[3:], "elu", batched)
    torch.testing.assert_close(got, want, **TOL)
    if grad:
        weights = torch.linspace(-1, 1, want.numel()).reshape(want.shape)
        for a, b in zip(torch.autograd.grad((got * weights).sum(), tensors),
                        torch.autograd.grad((want * weights).sum(), tensors)):
            torch.testing.assert_close(a, b, **TOL)


def test_vmap_over_another_dim_matches_loop():
    """The vmapped dim second (x [B, G, D], weights [out, G, in], biases
    [out, G]): the rule moves it first and makes each set's rows contiguous."""
    x, *params = sets(2)
    moved = [x.movedim(0, 1)] + [t.movedim(0, 1) for t in params]
    got = vmapped_chain((True,) * 5, "selu", in_dim=1)(moved[0], moved[1:3], moved[3:])
    torch.testing.assert_close(got, loop(x, params[:2], params[2:], "selu", (True,) * 5), **TOL)


def test_vmap_over_x_alone_is_the_folded_call():
    """One weight set for every vmapped call: the rule folds the vmapped
    axis into rows, one ordinary call at [G * B, D_0], bit for bit."""
    x, w0, w1, b0, b1 = sets(3)
    ws, bs = [w0[0], w1[0]], [b0[0], b1[0]]
    calls = []
    ordinary = fm.plain_mlp

    def counted(xx, *args):
        calls.append(tuple(xx.shape))
        return ordinary(xx, *args)

    fm.plain_mlp = counted
    try:
        with torch.no_grad():
            got = torch.func.vmap(lambda xx: fm.fused_mlp(xx, ws, bs, "elu"))(x)
    finally:
        fm.plain_mlp = ordinary
    assert calls == [(G * B, DIMS[0])]
    assert torch.equal(got, fm.plain_mlp(x.reshape(G * B, -1), ws, bs, "elu").reshape(G, B, -1))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_vmap_of_fused_module_over_stacked_state_dicts(grad):
    """A FusedMLP through functional_call over G stacked state_dicts (a
    self-play env's slots), each set's rows its own: outputs and the
    gradients of the stacked weights against a loop over the modules."""
    mlp = L.FusedMLP(DIMS[0], list(DIMS[1:]), "elu", device="cpu")
    modules = []
    for g in range(G):
        m = L.FusedMLP(DIMS[0], list(DIMS[1:]), "elu", device="cpu")
        torch.manual_seed(g)
        for p in m.parameters():
            torch.nn.init.uniform_(p, -0.5, 0.5)
        modules.append(m)
    stacked = {k: torch.stack([m.state_dict()[k] for m in modules]).requires_grad_(grad)
               for k in mlp.state_dict()}
    x = sets(4)[0]
    with torch.set_grad_enabled(grad):
        got = torch.func.vmap(lambda w, xx: torch.func.functional_call(mlp, w, (xx,)))(stacked, x)
        want = torch.stack([torch.func.functional_call(
            mlp, {k: v[g] for k, v in stacked.items()}, (x[g],)) for g in range(G)])
    torch.testing.assert_close(got, want, **TOL)
    if grad:
        leaves = list(stacked.values())
        for a, b in zip(torch.autograd.grad(got.square().sum(), leaves),
                        torch.autograd.grad(want.square().sum(), leaves)):
            torch.testing.assert_close(a, b, **TOL)


def test_grouped_operator_opcheck():
    """The registered grouped operator's schema, fake and autograd
    registrations (torch.library.opcheck), a weight shared."""
    x, w0, w1, b0, b1 = sets(5)
    args = (x, [w0.requires_grad_(), w1[0].requires_grad_()], [b0, b1], "tanh")
    torch.library.opcheck(fm.fused_mlp_grouped_op, args)


def refused(exc, match, x, ws, bs, activation="elu"):
    before = (fm.fused_mlp_launches, fm.fused_mlp_grouped_launches)
    with pytest.raises(exc, match=match):
        fm.fused_mlp_grouped_cuda(x, ws, bs, activation)
    assert (fm.fused_mlp_launches, fm.fused_mlp_grouped_launches) == before


def test_grouped_cuda_wrapper_refusals():
    """A CPU tensor, float64, rows that are not contiguous, shapes that do
    not chain, set axes that disagree or are missing, and more sets than the
    launch's grid takes: each raises before any launch."""
    x, w0, w1, b0, b1 = sets(6)
    refused(ValueError, "CUDA device", x, [w0, w1], [b0, b1])
    refused(TypeError, "float32", x.double(), [w0, w1], [b0, b1])
    refused(ValueError, "contiguous", x, [w0, w1.transpose(1, 2).contiguous().transpose(1, 2)], [b0, b1])
    refused(ValueError, r"ws\[1\] must be", x, [w0, w1[:, :, :-1]], [b0, b1])
    refused(ValueError, r"bs\[0\] must be", x, [w0, w1], [b0[:, :-1], b1])
    refused(ValueError, "set axes must agree", x, [w0[:-1], w1], [b0, b1])
    refused(ValueError, "set axes must agree", x[0], [w0[0], w1[0]], [b0[0], b1[0]])
    refused(ValueError, "2 weights but 1 biases", x, [w0, w1], [b0])
    refused(ValueError, "no activation", x, [w0, w1], [b0, b1], "mish")
    many = fm.MAX_GROUPS + 1  # shared rows expanded: no memory
    refused(ValueError, "at most 65535 weight sets", x[0].expand(many, B, DIMS[0]), [w0[0].expand(many, 7, 5), w1[0]],
            [b0[0], b1[0]])


@pytest.mark.parametrize("activation", ["elu", "relu", "softplus"])
@pytest.mark.parametrize("dims,batch", [((37, 50, 33, 7), 19), ((6, 128, 64), 1)])
def test_vmapped_operator_matches_jax_vmap(dims, batch, activation):
    """The JAX package's ``fused_mlp`` under ``jax.vmap`` over per-set
    weights (its route off the TPU: ``plain_mlp``) against
    ``torch.func.vmap`` of the port's (the operator's vmap rule, one grouped
    call), the same numpy draws carried across transposed, at
    rtol = atol = 1e-5."""
    rng = np.random.default_rng(7)
    groups = 3
    ws = [(rng.normal(size=(groups, dims[i], dims[i + 1])) * 0.3).astype(np.float32) for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=(groups, dims[i + 1])) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    x = rng.normal(size=(groups, batch, dims[0])).astype(np.float32)
    want = np.asarray(jax.vmap(lambda xx, w, b: jfm.fused_mlp(xx, tuple(w), tuple(b), activation))(x, ws, bs))
    tws = [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))) for w in ws]
    with torch.no_grad():
        got = torch.func.vmap(lambda xx, w, b: fm.fused_mlp(xx, w, b, activation))(
            torch.from_numpy(x), tws, [torch.from_numpy(b) for b in bs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
