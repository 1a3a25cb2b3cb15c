"""Optimizer update ops, in place.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_optim.py``
(reference: src/operator/optimizer_op-inl.h, contrib/adamw.cc,
contrib/all_finite.cc, contrib/multi_sum_sq.cc, optimizer_op.cc's
multi-tensor and multi-precision variants, contrib/preloaded_multi_sgd.cc)
with the same ``rescale_grad``, ``clip_gradient`` (a value <= 0 disables
it) and ``wd`` arithmetic.

The JAX ops are pure functions whose results the optimizer swaps into
the NDArray. These write **in place**, under ``torch.no_grad()``, into
the weight and state tensors they are given, and return those same
tensors, as MXNet's own kernels do. A parameter's tensor is the
``torch.nn.Parameter`` its blocks registered (``Parameter._attach``), so
an update must never swap it for a new one: the blocks would keep the
old. A multi-precision op (``mp_*``, ``multi_mp_*``) computes on the
float32 master copy and writes the half weight as its cast.

The arithmetic of SGD (with and without momentum), NAG, Adam, signSGD
and Signum is written once, over lists of tensors with torch's
multi-tensor ``_foreach_*`` ops (``*_lists``): a single-tensor op runs
it on a list of one, and the Trainer's fused step
(``gluon/fused_step.py``) on a whole parameter group, so the two give
the same bits. Each scalar (``lr``, ``wd``, ``rescale_grad``) may be a
Python number or a 0-d tensor on the weights' device (the fused step's
device scalars); it only ever multiplies, so either rounds the same.
The other updates (RMSProp, Ftrl, AdaGrad, AdaDelta, AdamW) are
per-tensor functions (``*_math``) that return new tensors; FTML's and
LAMB's ops (no fused kernel uses them) compute in place directly, and
``multi_lars`` returns the layer-wise rates. The JAX
package left all of this to XLA; the port leaves it to torch.
"""
from __future__ import annotations

import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    return grad


def _prep_grads(gs, rescale_grad, clip_gradient):
    gs = torch._foreach_mul(gs, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        gs = torch._foreach_clamp_max(
            torch._foreach_clamp_min(gs, -clip_gradient), clip_gradient)
    return gs


def _commit(dsts, srcs):
    """Write the new values into the tensors, in place."""
    with torch.no_grad():
        for d, s in zip(dsts, srcs):
            d.copy_(s)


# -- the multi-tensor arithmetic (lists of tensors in, new lists out) ------

def sgd_lists(ws, gs, lr, wd, rescale_grad, clip_gradient):
    """w - lr * (rescale*clip(g) + wd*w), for each (w, g)."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    d = torch._foreach_mul(torch._foreach_add(gs, torch._foreach_mul(
        ws, wd)), lr)
    return torch._foreach_sub(ws, d)


def sgd_mom_lists(ws, gs, ms, lr, momentum, wd, rescale_grad,
                  clip_gradient):
    """mom' = momentum*mom - lr*(rescale*clip(g) + wd*w); w' = w + mom'."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    d = torch._foreach_mul(torch._foreach_add(gs, torch._foreach_mul(
        ws, wd)), lr)
    ms2 = torch._foreach_sub(torch._foreach_mul(ms, momentum), d)
    return torch._foreach_add(ws, ms2), ms2


def nag_mom_lists(ws, gs, ms, lr, momentum, wd, rescale_grad,
                  clip_gradient):
    """g' = rescale*clip(g) + wd*w; mom' = momentum*mom + g';
    w' = w - lr*(g' + momentum*mom')."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    gs = torch._foreach_add(gs, torch._foreach_mul(ws, wd))
    ms2 = torch._foreach_add(torch._foreach_mul(ms, momentum), gs)
    d = torch._foreach_mul(torch._foreach_add(
        gs, torch._foreach_mul(ms2, momentum)), lr)
    return torch._foreach_sub(ws, d), ms2


def adam_lists(ws, gs, means, vars_, lr, beta1, beta2, epsilon, wd,
               rescale_grad, clip_gradient):
    """One Adam step (``lr`` arrives bias-corrected): g' = rescale*clip(g)
    + wd*w; m' = b1*m + (1-b1)*g'; v' = b2*v + (1-b2)*g'^2;
    w' = w - lr*m'/(sqrt(v') + eps)."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    gs = torch._foreach_add(gs, torch._foreach_mul(ws, wd))
    m2 = torch._foreach_add(torch._foreach_mul(means, beta1),
                            torch._foreach_mul(gs, 1 - beta1))
    v2 = torch._foreach_add(torch._foreach_mul(vars_, beta2),
                            torch._foreach_mul(torch._foreach_mul(gs, gs),
                                               1 - beta2))
    d = torch._foreach_div(torch._foreach_mul(m2, lr),
                           torch._foreach_add(torch._foreach_sqrt(v2),
                                              epsilon))
    return torch._foreach_sub(ws, d), m2, v2


def signsgd_lists(ws, gs, lr, wd, rescale_grad, clip_gradient):
    """w - lr * (sign(rescale*clip(g)) + wd*w)."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    d = torch._foreach_mul(torch._foreach_add(
        torch._foreach_sign(gs), torch._foreach_mul(ws, wd)), lr)
    return torch._foreach_sub(ws, d)


def signum_lists(ws, gs, ms, lr, momentum, wd, rescale_grad, clip_gradient,
                 wd_lh):
    """mom' = momentum*mom - (1-momentum)*(rescale*clip(g) + wd*w);
    w' = (1 - lr*wd_lh)*w + lr*sign(mom')."""
    gs = _prep_grads(gs, rescale_grad, clip_gradient)
    ms2 = torch._foreach_sub(
        torch._foreach_mul(ms, momentum),
        torch._foreach_mul(torch._foreach_add(gs, torch._foreach_mul(
            ws, wd)), 1 - momentum))
    keep = 1 - lr * wd_lh
    ws2 = torch._foreach_add(torch._foreach_mul(ws, keep),
                             torch._foreach_mul(torch._foreach_sign(ms2),
                                                lr))
    return ws2, ms2


# -- per-tensor arithmetic (new tensors out) -------------------------------

def rmsprop_math(weight, grad, n, lr, gamma1, epsilon, wd, rescale_grad,
                 clip_gradient, clip_weights):
    grad = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1 - gamma1) * torch.square(grad) + gamma1 * n
    w_new = weight - lr * grad / torch.sqrt(n_new + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w_new = w_new.clamp(-clip_weights, clip_weights)
    return w_new, n_new


def rmspropalex_math(weight, grad, n, g, delta, lr, gamma1, gamma2, epsilon,
                     wd, rescale_grad, clip_gradient, clip_weights):
    grad = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1 - gamma1) * torch.square(grad) + gamma1 * n
    g_new = (1 - gamma1) * grad + gamma1 * g
    delta_new = gamma2 * delta - lr * grad / torch.sqrt(
        n_new - torch.square(g_new) + epsilon)
    w_new = weight + delta_new
    if clip_weights is not None and clip_weights > 0:
        w_new = w_new.clamp(-clip_weights, clip_weights)
    return w_new, n_new, g_new, delta_new


def ftrl_math(weight, grad, z, n, lr, lamda1, beta, wd, rescale_grad,
              clip_gradient):
    grad = _prep_grad(grad, rescale_grad, clip_gradient)
    n_new = n + torch.square(grad)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + grad - sigma * weight
    w_new = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros((), dtype=z_new.dtype,
                                                device=z_new.device),
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return w_new.to(weight.dtype), z_new, n_new


def adagrad_math(weight, grad, history, lr, eps, wd, rescale_grad,
                 clip_gradient):
    """AdaGrad as the JAX package's ``AdaGrad.update`` computes it
    (``mxnet_tpu/optimizer/optimizer.py:403``): a set ``clip_gradient``
    clips even when <= 0, and eps sits inside the square root."""
    grad = grad * rescale_grad
    if clip_gradient is not None:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    h2 = history + grad * grad
    div = grad / torch.sqrt(h2 + eps)
    return weight - lr * (div + wd * weight), h2


def adadelta_math(weight, grad, acc_g, acc_delta, rho, epsilon, wd,
                  rescale_grad, clip_gradient):
    """AdaDelta as ``AdaDelta.update`` computes it
    (``mxnet_tpu/optimizer/optimizer.py:509``); it takes no learning
    rate."""
    grad = grad * rescale_grad
    if clip_gradient is not None:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    acc_g2 = rho * acc_g + (1 - rho) * grad * grad
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g2 + epsilon) \
        * grad
    acc_d2 = rho * acc_delta + (1 - rho) * delta * delta
    return weight - delta - wd * weight, acc_g2, acc_d2


def adamw_math(weight, grad, mean, var, lr, eta, beta1, beta2, epsilon, wd,
               rescale_grad, clip_gradient):
    grad = _prep_grad(grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * grad
    var_new = beta2 * var + (1 - beta2) * torch.square(grad)
    w_new = weight - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                            + wd * weight)
    return w_new, mean_new, var_new


# -- single-tensor ops ------------------------------------------------------

@register(differentiable=False)
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w -= lr * (rescale*clip(g) + wd*w), in place; returns ``weight``
    (reference: optimizer_op.cc sgd_update)."""
    (w2,) = sgd_lists([weight], [grad], lr, wd, rescale_grad, clip_gradient)
    _commit([weight], [w2])
    return weight


@register(differentiable=False)
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*(rescale*clip(g) + wd*w); w += mom, in
    place; returns (weight, mom) (reference: optimizer_op.cc
    sgd_mom_update)."""
    (w2,), (m2,) = sgd_mom_lists([weight], [grad], [mom], lr, momentum, wd,
                                 rescale_grad, clip_gradient)
    _commit([weight, mom], [w2, m2])
    return weight, mom


@register(differentiable=False)
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov accelerated SGD step, in place; returns (weight, mom)
    (reference: optimizer_op.cc nag_mom_update)."""
    (w2,), (m2,) = nag_mom_lists([weight], [grad], [mom], lr, momentum, wd,
                                 rescale_grad, clip_gradient)
    _commit([weight, mom], [w2, m2])
    return weight, mom


@register(differentiable=False)
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """One Adam step over the (mean, var) moments, in place; returns
    (weight, mean, var) (reference: optimizer_op.cc adam_update). ``lr``
    arrives bias-corrected from the optimizer."""
    (w2,), (m2,), (v2,) = adam_lists([weight], [grad], [mean], [var], lr,
                                     beta1, beta2, epsilon, wd, rescale_grad,
                                     clip_gradient)
    _commit([weight, mean, var], [w2, m2, v2])
    return weight, mean, var


@register(differentiable=False)
def adamw_update(weight, grad, mean, var, lr, eta=1.0, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdamW with decoupled weight decay, in place; returns (weight, mean,
    var) (reference: src/operator/contrib/adamw.cc)."""
    new = adamw_math(weight, grad, mean, var, lr, eta, beta1, beta2, epsilon,
                     wd, rescale_grad, clip_gradient)
    _commit([weight, mean, var], new)
    return weight, mean, var


@register(differentiable=False)
def rmsprop_update(weight, grad, n, lr, gamma1=0.9, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp step over the squared-grad accumulator n, in place; returns
    (weight, n) (reference: optimizer_op.cc rmsprop_update)."""
    new = rmsprop_math(weight, grad, n, lr, gamma1, epsilon, wd,
                       rescale_grad, clip_gradient, clip_weights)
    _commit([weight, n], new)
    return weight, n


@register(differentiable=False)
def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95, gamma2=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp (Graves/Alex) step with first moment g and delta momentum,
    in place; returns (weight, n, g, delta) (reference: optimizer_op.cc
    rmspropalex_update)."""
    new = rmspropalex_math(weight, grad, n, g, delta, lr, gamma1, gamma2,
                           epsilon, wd, rescale_grad, clip_gradient,
                           clip_weights)
    _commit([weight, n, g, delta], new)
    return weight, n, g, delta


@register(differentiable=False)
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal step over (z, n), in place; returns (weight, z, n)
    (reference: optimizer_op.cc ftrl_update)."""
    new = ftrl_math(weight, grad, z, n, lr, lamda1, beta, wd, rescale_grad,
                    clip_gradient)
    _commit([weight, z, n], new)
    return weight, z, n


@register(differentiable=False)
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """signSGD step w -= lr * (sign(g) + wd*w), in place; returns
    ``weight`` (reference: optimizer_op.cc signsgd_update)."""
    (w2,) = signsgd_lists([weight], [grad], lr, wd, rescale_grad,
                          clip_gradient)
    _commit([weight], [w2])
    return weight


@register(differentiable=False)
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum step, momentum then sign, in place; returns (weight, mom)
    (reference: optimizer_op.cc signum_update)."""
    (w2,), (m2,) = signum_lists([weight], [grad], [mom], lr, momentum, wd,
                                rescale_grad, clip_gradient, wd_lh)
    _commit([weight, mom], [w2, m2])
    return weight, mom


@register(differentiable=False)
def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    """FTML step t over the (d, v, z) state, in place; returns (weight,
    d, v, z) (reference: optimizer_op.cc ftml_update;
    ``mxnet_tpu/ndarray/ops_optim.py:148``)."""
    grad = _prep_grad(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1 - beta2) * torch.square(grad)
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * grad - sigma * weight
    _commit([weight, d, v, z], [-z_new / d_new, d_new, v_new, z_new])
    return weight, d, v, z


@register(differentiable=False)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's first phase: the moments updated in place and the
    (bias-corrected) Adam direction plus weight decay, no learning rate;
    returns (direction, mean, var) (reference: optimizer_op.cc
    lamb_update_phase1; ``mxnet_tpu/ndarray/ops_optim.py:162``)."""
    grad = _prep_grad(grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * grad
    var_new = beta2 * var + (1 - beta2) * torch.square(grad)
    m, v = mean_new, var_new
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    g = m / (torch.sqrt(v) + epsilon) + wd * weight
    _commit([mean, var], [mean_new, var_new])
    return g, mean, var


@register(differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's second phase: the step ``lr * r1/r2 * g`` (the trust ratio
    of the weight's norm r1 to the direction's r2, 1 where either is 0,
    clamped to the bounds that are positive), in place; returns the
    weight (reference: optimizer_op.cc lamb_update_phase2;
    ``mxnet_tpu/ndarray/ops_optim.py:179``). The norms stay on the
    device: nothing is read back."""
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    if lower_bound > 0:
        ratio = torch.clamp(ratio, min=lower_bound)
    if upper_bound > 0:
        ratio = torch.clamp(ratio, max=upper_bound)
    _commit([weight], [weight - lr * ratio * g])
    return weight


@register(differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-9,
               rescale_grad=1.0):
    """Layer-wise LARS rates: ``lrs * eta * |w| / (|g| + wd * |w| +
    eps)`` from the stacked per-layer squared norms (``multi_sum_sq``),
    ``lrs`` itself where either norm is 0 (reference:
    contrib/multi_lars.cc; ``mxnet_tpu/ndarray/ops_optim.py:352``)."""
    wnorm = torch.sqrt(weights_sum_sq)
    gnorm = torch.sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * wnorm / (gnorm + wds * wnorm + eps)
    one = torch.ones_like(ratio)
    return lrs * torch.where(wnorm > 0, torch.where(gnorm > 0, ratio, one),
                             one)


@register(differentiable=False)
def all_finite(*arrays, init_output=True):
    """1.0 if every element of every array is finite, else 0.0, as a (1,)
    float32 tensor (reference: contrib/all_finite.cc, which the AMP loss
    scaler reads)."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device) \
        if arrays else torch.ones((), dtype=torch.bool)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)


@register(differentiable=False)
def multi_all_finite(*arrays, num_arrays=0, init_output=True):
    """One flag over every input (reference: src/operator/all_finite.cc
    MultiAllFinite)."""
    return all_finite(*arrays)


@register(differentiable=False)
def multi_sum_sq(*arrays):
    """The sum of squares of each array, each as a (1,) tensor
    (reference: contrib/multi_sum_sq.cc, used by LARS)."""
    return tuple(torch.square(a).sum().reshape(1) for a in arrays)


# -- multi-tensor ops (reference: optimizer_op.cc MultiSGDUpdate and its
# momentum and multi-precision variants; contrib/preloaded_multi_sgd.cc,
# where lrs and wds arrive as tensors). The weights (and states) are
# written in place and come back in the JAX op's output order.

def _scalar_list(v, n, name):
    if v is None:
        raise ValueError(f"{name} is required")
    if not isinstance(v, (list, tuple)):
        v = [v] * n
    if len(v) != n:
        raise ValueError(f"{name} has {len(v)} entries for {n} weights")
    return [float(x) for x in v]


def _multi_n(num_weights, nargs, per):
    n = int(num_weights) if num_weights else nargs // per
    if nargs != n * per:
        raise ValueError(
            f"expected {n * per} inputs ({per} per weight), got {nargs}")
    return n


def _preloaded(args):
    if len(args) < 2:
        raise ValueError("missing lrs/wds tensor inputs")
    return args[:-2], args[-2], args[-1]


@register(differentiable=False)
def multi_sgd_update(*args, lrs=None, wds=None, num_weights=0,
                     rescale_grad=1.0, clip_gradient=-1.0):
    """Inputs interleaved [w0, g0, w1, g1, ...]; returns the weights."""
    n = _multi_n(num_weights, len(args), 2)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    for i in range(n):
        w, g = args[2 * i], args[2 * i + 1]
        sgd_update(w, g.to(w.dtype), lrs[i], wds[i], rescale_grad,
                   clip_gradient)
    return tuple(args[2 * i] for i in range(n))


@register(differentiable=False)
def multi_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0,
                         num_weights=0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    """Inputs [w0, g0, m0, w1, g1, m1, ...]; returns
    (w0, ..., wn-1, m0, ..., mn-1)."""
    n = _multi_n(num_weights, len(args), 3)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    for i in range(n):
        w, g, m = args[3 * i:3 * i + 3]
        sgd_mom_update(w, g.to(w.dtype), m, lrs[i], momentum, wds[i],
                       rescale_grad, clip_gradient)
    return tuple(args[3 * i] for i in range(n)) + \
        tuple(args[3 * i + 2] for i in range(n))


def _mp_sgd(w, g, w32, lr, wd, rescale_grad, clip_gradient):
    sgd_update(w32, g.to(torch.float32), lr, wd, rescale_grad, clip_gradient)
    _commit([w], [w32])


def _mp_sgd_mom(w, g, m, w32, lr, momentum, wd, rescale_grad, clip_gradient):
    sgd_mom_update(w32, g.to(torch.float32), m, lr, momentum, wd,
                   rescale_grad, clip_gradient)
    _commit([w], [w32])


@register(differentiable=False)
def multi_mp_sgd_update(*args, lrs=None, wds=None, num_weights=0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    """Mixed precision: inputs [w0, g0, w32_0, ...], half weights and
    gradients with a float32 master each; returns (w0, ..., w32_0, ...)
    (reference MultiMPSGDUpdate)."""
    n = _multi_n(num_weights, len(args), 3)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    for i in range(n):
        w, g, w32 = args[3 * i:3 * i + 3]
        _mp_sgd(w, g, w32, lrs[i], wds[i], rescale_grad, clip_gradient)
    return tuple(args[3 * i] for i in range(n)) + \
        tuple(args[3 * i + 2] for i in range(n))


@register(differentiable=False)
def multi_mp_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0,
                            num_weights=0, rescale_grad=1.0,
                            clip_gradient=-1.0):
    """Inputs [w0, g0, m0, w32_0, ...]; returns (w..., mom..., w32...).
    Momentum and master stay float32."""
    n = _multi_n(num_weights, len(args), 4)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    for i in range(n):
        w, g, m, w32 = args[4 * i:4 * i + 4]
        _mp_sgd_mom(w, g, m, w32, lrs[i], momentum, wds[i], rescale_grad,
                    clip_gradient)
    return tuple(args[4 * i + k] for k in (0, 2, 3) for i in range(n))


@register(differentiable=False)
def preloaded_multi_sgd_update(*args, num_weights=0, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """Like ``multi_sgd_update``, with ``lrs`` and ``wds`` as the last two
    tensor inputs (shape (n,)), so the schedule stays on the device."""
    args, lrs, wds = _preloaded(args)
    n = _multi_n(num_weights, len(args), 2)
    for i in range(n):
        w, g = args[2 * i], args[2 * i + 1]
        sgd_update(w, g.to(w.dtype), lrs[i].to(w.dtype), wds[i].to(w.dtype),
                   rescale_grad, clip_gradient)
    return tuple(args[2 * i] for i in range(n))


@register(differentiable=False)
def preloaded_multi_sgd_mom_update(*args, momentum=0.0, num_weights=0,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    """[w0, g0, m0, ..., lrs, wds] -> (w..., m...)."""
    args, lrs, wds = _preloaded(args)
    n = _multi_n(num_weights, len(args), 3)
    for i in range(n):
        w, g, m = args[3 * i:3 * i + 3]
        sgd_mom_update(w, g.to(w.dtype), m, lrs[i].to(w.dtype), momentum,
                       wds[i].to(w.dtype), rescale_grad, clip_gradient)
    return tuple(args[3 * i] for i in range(n)) + \
        tuple(args[3 * i + 2] for i in range(n))


@register(differentiable=False)
def preloaded_multi_mp_sgd_update(*args, num_weights=0, rescale_grad=1.0,
                                  clip_gradient=-1.0):
    """[w, g, w32]*n + [lrs, wds] -> (w..., w32...)."""
    args, lrs, wds = _preloaded(args)
    n = _multi_n(num_weights, len(args), 3)
    for i in range(n):
        w, g, w32 = args[3 * i:3 * i + 3]
        _mp_sgd(w, g, w32, lrs[i], wds[i], rescale_grad, clip_gradient)
    return tuple(args[3 * i] for i in range(n)) + \
        tuple(args[3 * i + 2] for i in range(n))


@register(differentiable=False)
def preloaded_multi_mp_sgd_mom_update(*args, momentum=0.0, num_weights=0,
                                      rescale_grad=1.0,
                                      clip_gradient=-1.0):
    """[w, g, m, w32]*n + [lrs, wds] -> (w..., m..., w32...)."""
    args, lrs, wds = _preloaded(args)
    n = _multi_n(num_weights, len(args), 4)
    for i in range(n):
        w, g, m, w32 = args[4 * i:4 * i + 4]
        _mp_sgd_mom(w, g, m, w32, lrs[i], momentum, wds[i], rescale_grad,
                    clip_gradient)
    return tuple(args[4 * i + k] for k in (0, 2, 3) for i in range(n))


# -- multi-precision single-tensor ops (optimizer_op.cc mp_*): the fp32
# master is updated and the half weight written as its cast

@register(differentiable=False)
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD; returns (weight, weight32) (reference:
    optimizer_op.cc mp_sgd_update)."""
    _mp_sgd(weight, grad, weight32, lr, wd, rescale_grad, clip_gradient)
    return weight, weight32


@register(differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """Multi-precision SGD with momentum; returns (weight, mom, weight32)
    (reference: optimizer_op.cc mp_sgd_mom_update)."""
    _mp_sgd_mom(weight, grad, mom, weight32, lr, momentum, wd, rescale_grad,
                clip_gradient)
    return weight, mom, weight32


@register(differentiable=False)
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Multi-precision NAG; returns (weight, mom, weight32) (reference:
    optimizer_op.cc mp_nag_mom_update)."""
    nag_mom_update(weight32, grad.to(torch.float32), mom, lr, momentum, wd,
                   rescale_grad, clip_gradient)
    _commit([weight], [weight32])
    return weight, mom, weight32


@register(differentiable=False)
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, lr,
                    eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, clip_gradient=-1.0):
    """Multi-precision AdamW; ``rescale_grad`` is a tensor input (the loss
    scale), as in the reference (contrib/adamw.cc MPUpdate); returns
    (weight, mean, var, weight32)."""
    scale = rescale_grad.reshape(()).to(torch.float32)
    new = adamw_math(weight32, grad.to(torch.float32), mean, var, lr, eta,
                     beta1, beta2, epsilon, wd, scale, clip_gradient)
    _commit([weight32, mean, var], new)
    _commit([weight], [weight32])
    return weight, mean, var, weight32


@register(differentiable=False)
def multi_adamw_update(*args, lrs=None, wds=None, etas=None, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, num_weights=0,
                       clip_gradient=-1.0):
    """Inputs [w, g, mean, var]*n + [rescale_grad tensor]; returns
    (w..., mean..., var...)."""
    n = _multi_n(num_weights, len(args) - 1, 4)
    scale = args[-1].reshape(()).to(torch.float32)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    etas = _scalar_list(etas, n, "etas")
    for i in range(n):
        w, g, m, v = args[4 * i:4 * i + 4]
        w2, m2, v2 = adamw_math(w, g.to(torch.float32), m, v, lrs[i],
                                etas[i], beta1, beta2, epsilon, wds[i],
                                scale, clip_gradient)
        _commit([w, m, v], [w2, m2, v2])
    return tuple(args[4 * i + k] for k in (0, 2, 3) for i in range(n))


@register(differentiable=False)
def multi_mp_adamw_update(*args, lrs=None, wds=None, etas=None, beta1=0.9,
                          beta2=0.999, epsilon=1e-8, num_weights=0,
                          clip_gradient=-1.0):
    """Inputs [w, g, mean, var, w32]*n + [rescale_grad]; returns
    (w..., mean..., var..., w32...)."""
    n = _multi_n(num_weights, len(args) - 1, 5)
    scale = args[-1].reshape(()).to(torch.float32)
    lrs, wds = _scalar_list(lrs, n, "lrs"), _scalar_list(wds, n, "wds")
    etas = _scalar_list(etas, n, "etas")
    for i in range(n):
        w, g, m, v, w32 = args[5 * i:5 * i + 5]
        new = adamw_math(w32, g.to(torch.float32), m, v, lrs[i], etas[i],
                         beta1, beta2, epsilon, wds[i], scale, clip_gradient)
        _commit([w32, m, v], new)
        _commit([w], [w32])
    return tuple(args[5 * i + k] for k in (0, 2, 3, 4) for i in range(n))
