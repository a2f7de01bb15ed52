"""PyMC (pytensor) integration layer.

Counterpart of ``celerite2_tpu/pymc_support.py``: ONE black-box likelihood
``Op`` whose ``perform`` calls the port's :func:`~celerite2_torch.gp_loglik`
on ``Config.device`` (the card) and whose gradient is a companion VJP
``Op`` through ``torch.autograd`` (the hand-derived adjoints come along),
plus a marginal random variable and the conditional moments.  Kernels are
built with this package's own term DSL inside the wrapped function.

As in the JAX package, the behavior lives in pytensor-independent cores
(:class:`LoglikCore`, :class:`MarginalCore`,
:class:`ConditionalMomentsCore` and the ``perform_*`` bodies), so the full
contract is tested without pymc; the gated shell is thin.  The data go
onto the device once, as tensors held by the closures (the JAX package
keeps them as numpy so that its jitted closures embed them as constants,
a TPU-runtime workaround with no counterpart here).  The JAX package's
``jax_funcify`` registrations, which hand PyMC's JAX samplers the raw JAX
function, have no counterpart either: pytensor has no PyTorch linker for
an external Op, so PyMC calls ``perform``.
"""

from __future__ import annotations

import numpy as np
import torch

from celerite2_torch.utils.misc import as_tensor, atleast_1d, resolve_device

__all__ = [
    "HAS_PYTENSOR",
    "LoglikCore",
    "MarginalCore",
    "ConditionalMomentsCore",
    "celerite_loglik_op",
    "marginal",
    "marginal_potential",
    "conditional",
]


def _params_on(device, params):
    """Host parameters (numbers, numpy arrays) as tensors on ``device``,
    each keeping its floating dtype."""
    return tuple(torch.as_tensor(np.asarray(p)).to(device) for p in params)


def _host(x):
    return x.detach().cpu().numpy()


def _vjp(fn, cotangents, params):
    """The cotangents of ``params`` for the outputs' ``cotangents``: one
    backward pass, zeros for a parameter the outputs do not depend on."""
    params = tuple(p.detach().requires_grad_(True) for p in params)
    with torch.enable_grad():
        outs = fn(*params)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cts = tuple(as_tensor(c, like=o) for c, o in zip(cotangents, outs))
        grads = torch.autograd.grad(outs, params, cts, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads))


class LoglikCore:
    """pytensor-independent engine of the black-box likelihood Op.

    Wraps ``fn(*params) -> scalar`` (typically :func:`make_gp_loglik_fn`'s
    closure over ``gp_loglik`` with fixed data) with value and VJP
    callables on host numpy arrays, the contract a pytensor
    ``Op.perform`` needs.  The parameters go to ``device`` (default
    ``Config.device``).  A kernel that is not positive definite gives the
    library's quiet ``-inf`` (and zero gradients), which ``pm.Potential``
    turns into a rejected step.
    """

    def __init__(self, fn, device=None):
        self.fn = fn
        self.device = resolve_device(device)

    def value(self, *params):
        with torch.no_grad():
            return _host(self.fn(*_params_on(self.device, params)))

    def grad(self, ct, *params):
        # a VJP with the output's cotangent (not a bare gradient): pytensor's
        # L_op supplies it, and chaining through it keeps second-order
        # graphs honest
        grads = _vjp(self.fn, (np.asarray(ct),), _params_on(self.device, params))
        return tuple(_host(g) for g in grads)


def perform_value(core, inputs, output_storage):
    """``Op.perform`` body for the value Op: writes the scalar loglik into
    ``output_storage[0][0]`` in the inputs' float dtype."""
    out = core.value(*inputs)
    dt = np.result_type(*[np.asarray(i).dtype for i in inputs])
    output_storage[0][0] = np.asarray(out, dtype=dt)


def perform_grad(core, inputs, output_storage):
    """``Op.perform`` body for the VJP Op: ``inputs`` is ``(ct,
    *params)``; writes one cotangent per parameter in its dtype."""
    ct, *params = inputs
    grads = core.grad(np.asarray(ct), *params)
    for slot, p, g in zip(output_storage, params, grads):
        slot[0] = np.asarray(g, dtype=np.asarray(p).dtype)


def _data(t, device, *arrays):
    """``t`` and the arrays beside it as tensors on ``device`` (None stays
    None)."""
    t = atleast_1d(t, device=device)
    return (t, *(None if x is None else as_tensor(x, like=t) for x in arrays))


def make_gp_loglik_fn(make_kernel, t, y, *, yerr=None, diag=None, mean=0.0,
                      device=None):
    """Close :func:`~celerite2_torch.gp_loglik` over fixed data: returns
    ``fn(*params) -> scalar`` with the kernel built by
    ``make_kernel(*params)`` (this package's term DSL).  The data go to
    ``device`` (default ``Config.device``) once."""
    from celerite2_torch.gp import gp_loglik

    t, y, yerr, diag = _data(t, device, y, yerr, diag)

    def fn(*params):
        return gp_loglik(make_kernel(*params), t, y, yerr=yerr, diag=diag,
                         mean=mean)

    return fn


class MarginalCore:
    """pytensor-independent engine of the marginal GP distribution.

    Pairs the log-density ``logp(value, *params)`` (a :class:`LoglikCore`
    with the observed vector first: the ``pm.CustomDist`` logp contract)
    with a prior sampler ``prior_draws(rng, size, *params)``, ``m + L
    sqrt(d) z`` through the semiseparable factor on the device, with the
    normals from a ``torch.Generator`` seeded from the numpy ``rng``.
    """

    def __init__(self, make_kernel, t, *, yerr=None, diag=None, mean=0.0,
                 device=None):
        from celerite2_torch.gp import gp_compute, gp_dot_tril, gp_loglik

        t, yerr, diag = _data(t, device, yerr, diag)
        self.n = t.shape[0]
        self.t = t

        def logp_fn(value, *params):
            return gp_loglik(make_kernel(*params), t, value, yerr=yerr,
                             diag=diag, mean=mean)

        self.logp = LoglikCore(logp_fn, device=t.device)

        def draw_fn(z, *params):
            # z: (K, N) standard normals -> (K, N) prior draws
            state = gp_compute(make_kernel(*params), t, yerr=yerr, diag=diag,
                               mean=mean)
            return gp_dot_tril(state, z.T).T + state.mean_value

        self._draw = draw_fn

    def prior_draws(self, rng, size, *params):
        shape = () if size is None else tuple(np.atleast_1d(size))
        k = int(np.prod(shape, dtype=int)) if shape else 1
        seed = int(rng.integers(2**63 - 1))
        g = torch.Generator(self.t.device).manual_seed(seed)
        z = torch.randn((k, self.n), generator=g, dtype=self.t.dtype,
                        device=self.t.device)
        with torch.no_grad():
            out = _host(self._draw(z, *_params_on(self.t.device, params)))
        return out.reshape(shape + (self.n,)) if shape else out[0]


class ConditionalMomentsCore:
    """pytensor-independent ``(mu, cov)`` of the conditional distribution.

    ``values(*params) -> (mu (M,), cov (M, M))`` and the matching VJP,
    built on :class:`~celerite2_torch.gp.ConditionalDistribution` (the
    O(N + M) mean and the dense covariance, the quantities a ``pm.MvNormal``
    over the targets takes).  ``component`` is an optional callable
    ``(*params) -> Term`` selecting a sub-kernel (``kernel=``).
    """

    def __init__(self, make_kernel, t, y, *, t_new=None, yerr=None,
                 diag=None, mean=0.0, include_mean=True, component=None,
                 device=None):
        from celerite2_torch.gp import GaussianProcess

        t_host = np.asarray(t)
        if np.any(t_host[1:] < t_host[:-1]):
            raise ValueError("The input coordinates must be sorted")
        t, y, yerr, diag = _data(t, device, y, yerr, diag)
        t_new = None if t_new is None else as_tensor(t_new, like=t)
        self.m = t.shape[0] if t_new is None else t_new.shape[-1]
        self.device = t.device

        def fn(*params):
            kernel = make_kernel(*params)
            # t was checked on the host above
            gp = GaussianProcess(
                kernel, t=t, yerr=yerr, diag=diag, mean=mean,
                check_sorted=False, quiet=True,
            )
            cond = gp.condition(
                y, t=t_new, include_mean=include_mean,
                kernel=None if component is None else component(*params),
            )
            return cond.mean, cond.covariance

        self.fn = fn

    def values(self, *params):
        with torch.no_grad():
            mu, cov = self.fn(*_params_on(self.device, params))
        return _host(mu), _host(cov)

    def vjp(self, gmu, gcov, *params):
        grads = _vjp(self.fn, (np.asarray(gmu), np.asarray(gcov)),
                     _params_on(self.device, params))
        return tuple(_host(g) for g in grads)


def perform_moments(core, inputs, output_storage):
    """``Op.perform`` body for the conditional-moments Op."""
    mu, cov = core.values(*inputs)
    dt = np.result_type(*[np.asarray(i).dtype for i in inputs])
    output_storage[0][0] = np.asarray(mu, dtype=dt)
    output_storage[1][0] = np.asarray(cov, dtype=dt)


def perform_moments_grad(core, inputs, output_storage):
    """``Op.perform`` body for the moments VJP Op: inputs are ``(gmu,
    gcov, *params)``."""
    gmu, gcov, *params = inputs
    grads = core.vjp(gmu, gcov, *params)
    for slot, p, g in zip(output_storage, params, grads):
        slot[0] = np.asarray(g, dtype=np.asarray(p).dtype)


try:  # pragma: no cover - pytensor is optional and absent in this image
    import pytensor.tensor as pt
    from pytensor.graph import basic
    from pytensor.graph import op as pt_op

    HAS_PYTENSOR = True

    # no __props__ on these Ops: props-based equality would make Ops over
    # different cores compare equal and let pytensor's merge rewrite
    # collapse distinct likelihoods
    class _CeleriteLoglikGradOp(pt_op.Op):
        def __init__(self, core):
            self.core = core
            super().__init__()

        def make_node(self, ct, *params):
            ct = pt.as_tensor_variable(ct)
            params = [pt.as_tensor_variable(p) for p in params]
            return basic.Apply(self, [ct, *params], [p.type() for p in params])

        def infer_shape(self, fgraph, node, shapes):
            return shapes[1:]

        def perform(self, node, inputs, output_storage):
            perform_grad(self.core, inputs, output_storage)

    class CeleriteLoglikOp(pt_op.Op):
        """Scalar GP log-likelihood as a pytensor Op."""

        def __init__(self, core):
            self.core = core
            self._grad_op = _CeleriteLoglikGradOp(core)
            super().__init__()

        def make_node(self, *params):
            params = [pt.as_tensor_variable(p) for p in params]
            out = pt.TensorType(params[0].dtype, ())()
            return basic.Apply(self, params, [out])

        def infer_shape(self, fgraph, node, shapes):
            return [()]

        def perform(self, node, inputs, output_storage):
            perform_value(self.core, inputs, output_storage)

        def grad(self, inputs, output_grads):
            # return_list: with ONE parameter __call__ would hand back a
            # bare Variable
            return self._grad_op(output_grads[0], *inputs, return_list=True)

    class _CeleriteMomentsGradOp(pt_op.Op):
        def __init__(self, core):
            self.core = core
            super().__init__()

        def make_node(self, gmu, gcov, *params):
            gmu = pt.as_tensor_variable(gmu)
            gcov = pt.as_tensor_variable(gcov)
            params = [pt.as_tensor_variable(p) for p in params]
            return basic.Apply(
                self, [gmu, gcov, *params], [p.type() for p in params]
            )

        def infer_shape(self, fgraph, node, shapes):
            return shapes[2:]

        def perform(self, node, inputs, output_storage):
            perform_moments_grad(self.core, inputs, output_storage)

    class CeleriteConditionalMomentsOp(pt_op.Op):
        """(mu, cov) of the conditional GP as one differentiable pytensor
        node."""

        def __init__(self, core):
            self.core = core
            self._grad_op = _CeleriteMomentsGradOp(core)
            super().__init__()

        def make_node(self, *params):
            params = [pt.as_tensor_variable(p) for p in params]
            dtype = params[0].dtype if params else "float64"
            m = self.core.m
            mu = pt.TensorType(dtype, shape=(m,))()
            cov = pt.TensorType(dtype, shape=(m, m))()
            return basic.Apply(self, params, [mu, cov])

        def infer_shape(self, fgraph, node, shapes):
            m = self.core.m
            return [(m,), (m, m)]

        def perform(self, node, inputs, output_storage):
            perform_moments(self.core, inputs, output_storage)

        def L_op(self, inputs, outputs, output_grads):
            from pytensor.gradient import DisconnectedType

            gmu, gcov = output_grads
            dtype = outputs[0].dtype
            m = self.core.m
            if isinstance(gmu.type, DisconnectedType):
                gmu = pt.zeros((m,), dtype=dtype)
            if isinstance(gcov.type, DisconnectedType):
                gcov = pt.zeros((m, m), dtype=dtype)
            return self._grad_op(gmu, gcov, *inputs, return_list=True)

except ImportError:  # pytensor/pymc not installed

    HAS_PYTENSOR = False

    class CeleriteLoglikOp:  # type: ignore[no-redef]
        """Fallback when pytensor is absent: the core stays reachable
        (``.core``), symbolic use needs the real dependency."""

        def __init__(self, core):
            self.core = core

        def __call__(self, *params):
            raise ImportError(
                "pymc/pytensor is not installed; use the built-in "
                "inference engine (celerite2_torch.inference), or install "
                "pymc to use this Op in a model"
            )

    class CeleriteConditionalMomentsOp:  # type: ignore[no-redef]
        """Fallback when pytensor is absent (as the loglik shell)."""

        def __init__(self, core):
            self.core = core

        def __call__(self, *params):
            raise ImportError(
                "pymc/pytensor is not installed; use "
                "GaussianProcess.condition / the built-in inference "
                "engine, or install pymc to use this Op in a model"
            )


def celerite_loglik_op(make_kernel, t, y, *, yerr=None, diag=None, mean=0.0,
                       device=None):
    """The marginal-likelihood Op for a PyMC model.

    Example::

        op = celerite_loglik_op(
            lambda s, r, tau: ct.SHOTerm(sigma=s, rho=r, tau=tau),
            t, y, yerr=yerr)
        with pm.Model():
            s = pm.HalfNormal("sigma", 1.0)
            ...
            pm.Potential("gp", op(s, r, tau))
    """
    fn = make_gp_loglik_fn(make_kernel, t, y, yerr=yerr, diag=diag, mean=mean,
                           device=device)
    return CeleriteLoglikOp(LoglikCore(fn, device=device))


def _register_citations(model=None):
    import pymc as pm

    from celerite2_torch.citation import CITATIONS

    model = pm.modelcontext(model)
    if not hasattr(model, "__citations__"):
        model.__citations__ = dict()
    model.__citations__["celerite2_torch"] = CITATIONS
    return model


def _vector_signature(params, support="(n)"):
    """gufunc-style CustomDist signature from the params' ndims, e.g. two
    scalars -> ``"(),()->(n)"``."""
    dims = []
    for i, p in enumerate(params):
        nd = getattr(p, "ndim", np.asarray(p).ndim)
        dims.append("(" + ",".join(f"p{i}d{j}" for j in range(nd)) + ")")
    return ",".join(dims) + "->" + support


def marginal_potential(name, make_kernel, params, t, y, *, yerr=None,
                       diag=None, mean=0.0, model=None, device=None):
    """Attach the GP marginal likelihood to the current PyMC model as a
    ``Potential`` (the observed data inside the Op).  Prefer
    :func:`marginal`, a full random variable."""
    import pymc as pm

    model = _register_citations(model)
    op = celerite_loglik_op(make_kernel, t, y, yerr=yerr, diag=diag,
                            mean=mean, device=device)
    return pm.Potential(name, op(*params), model=model)


def marginal(name, make_kernel, params, t, *, observed=None, yerr=None,
             diag=None, mean=0.0, model=None, device=None, **kwargs):
    """The GP marginal as a PyMC random variable: one ``pm.CustomDist``
    whose ``logp`` is the likelihood Op and whose ``random`` draws ``m + L
    sqrt(d) z`` on the device, so that prior and posterior predictive
    sampling work."""
    import pymc as pm

    _register_citations(model)
    core = MarginalCore(make_kernel, t, yerr=yerr, diag=diag, mean=mean,
                        device=device)
    op = CeleriteLoglikOp(core.logp)

    def logp(value, *ps):
        return op(value, *ps)

    def random(*args, rng=None, size=None):
        return core.prior_draws(rng, size, *args)

    params = tuple(params)
    return pm.CustomDist(
        name, *params, logp=logp, random=random,
        signature=_vector_signature(params), observed=observed, **kwargs,
    )


def conditional(name, make_kernel, params, t, y, *, t_new=None, yerr=None,
                diag=None, mean=0.0, include_mean=True, component=None,
                model=None, device=None, **kwargs):
    """The conditional (predictive) density over the targets as a
    ``pm.MvNormal`` whose ``(mu, cov)`` come from one differentiable
    conditional-moments Op."""
    import pymc as pm

    _register_citations(model)
    core = ConditionalMomentsCore(
        make_kernel, t, y, t_new=t_new, yerr=yerr, diag=diag, mean=mean,
        include_mean=include_mean, component=component, device=device,
    )
    op = CeleriteConditionalMomentsOp(core)
    mu, cov = op(*params)
    shape = kwargs.pop("shape", core.m)
    return pm.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)
