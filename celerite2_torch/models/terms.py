"""The celerite kernel ("term") DSL on PyTorch tensors.

Counterpart of ``celerite2_tpu/models/terms.py``.  A term models

    k(tau) = sum_j ar_j * exp(-cr_j * tau)
           + sum_j exp(-cc_j * tau) * (ac_j cos(dc_j tau) + bc_j sin(dc_j tau))

and exposes the semiseparable representation ``(c, a, U, V)`` with

    K[n, m] = sum_j U[n, j] * V[m, j] * exp(-c_j (t[n] - t[m]))   (n > m)

through :meth:`Term.get_celerite_matrices`.

Parameters are tensors (numbers and numpy arrays are converted; tensors
are kept, so autograd flows to them).  Each primitive term is ONE
component, and its parameters' shape is a batch shape: parameters of
shape ``(C,)`` describe C kernels at once (one per sampler chain), and
the matrices then come out as ``c (C, J)``, ``a (C, N)``, ``U, V
(C, N, J)``.  Every method computes in the dtype and on the device of
its input tensor (``x``, ``tau`` or ``omega``).

``SHOTerm`` is branchless: both damping regimes are evaluated and one
is picked with ``torch.where``, so a batch may mix regimes.
"""

from __future__ import annotations

import math

import torch

from celerite2_torch.utils.misc import as_tensor, atleast_1d, first_device

__all__ = [
    "Term",
    "TermSum",
    "TermProduct",
    "TermDiff",
    "TermConvolution",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "RotationTerm",
    "OriginalCeleriteTerm",
    "resolve_parameter_spec",
]


def _cat_last(parts):
    """Concatenate along the last axis, broadcasting the leading axes."""
    batch = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(*batch, p.shape[-1]) for p in parts], -1)


def _tensors(*values):
    """Parameters as tensors: the numbers among them follow the first
    tensor's device (else the package default)."""
    device = first_device(*values)
    return tuple(as_tensor(v, device=device) for v in values)


def _lift(coef, ndim):
    """(*B, n) coefficients -> (*B, 1 x ndim, n), to broadcast against
    an ndim-dimensional lag array carrying a trailing component axis."""
    return coef.reshape(coef.shape[:-1] + (1,) * ndim + coef.shape[-1:])


class Term:
    """Abstract base term.

    Subclasses define ``_params`` (parameter attribute names) and either
    :meth:`get_coefficients` or the matrix/value/psd methods directly
    (as :class:`SHOTerm` does).
    """

    _params: tuple = ()

    def __add__(self, other):
        return TermSum(self, other)

    def __mul__(self, other):
        return TermProduct(self, other)

    @property
    def terms(self):
        return (self,)

    def to(self, *args, **kwargs):
        """A copy whose parameters are ``param.to(*args, **kwargs)``
        (differentiable, like ``Tensor.to``)."""
        new = object.__new__(type(self))
        for name in self._params:
            setattr(new, name, getattr(self, name).to(*args, **kwargs))
        return new

    # ------------------------------------------------------ coefficients
    def get_coefficients(self):
        """Return ``(ar, cr, ac, bc, cc, dc)``, each ``(*batch, n)``."""
        raise NotImplementedError("subclasses must implement this method")

    @property
    def width(self) -> int:
        """The celerite width J implied by this term's structure."""
        ar, _, ac, _, _, _ = self.get_coefficients()
        return ar.shape[-1] + 2 * ac.shape[-1]

    # ------------------------------------------------------- evaluation
    def get_value(self, tau):
        """Evaluate k(tau); the result is ``(*batch, *tau.shape)``."""
        tau = torch.abs(atleast_1d(tau))
        ar, cr, ac, bc, cc, dc = (
            _lift(x.to(tau), tau.ndim) for x in self.get_coefficients()
        )
        tau = tau[..., None]
        k = torch.sum(ar * torch.exp(-cr * tau), dim=-1)
        arg = dc * tau
        k = k + torch.sum(
            torch.exp(-cc * tau) * (ac * torch.cos(arg) + bc * torch.sin(arg)),
            dim=-1,
        )
        return k

    def get_psd(self, omega):
        """Power spectral density; the result is ``(*batch, *omega.shape)``."""
        omega = atleast_1d(omega)
        ar, cr, ac, bc, cc, dc = (
            _lift(x.to(omega), omega.ndim) for x in self.get_coefficients()
        )
        w2 = omega[..., None] ** 2
        psd = torch.sum(ar * cr / (cr**2 + w2), dim=-1)
        w02 = cc**2 + dc**2
        psd = psd + torch.sum(
            ((ac * cc + bc * dc) * w02 + (ac * cc - bc * dc) * w2)
            / (w2**2 + 2.0 * (cc * cc - dc * dc) * w2 + w02 * w02),
            dim=-1,
        )
        return math.sqrt(2.0 / math.pi) * psd

    def to_dense(self, x, diag):
        """Dense covariance matrix (test oracle)."""
        x = atleast_1d(x)
        K = self.get_value(x[..., :, None] - x[..., None, :])
        return K + torch.diag_embed(as_tensor(diag, like=x).expand(x.shape))

    # ----------------------------------------------------- the matrices
    def get_celerite_matrices(self, x, diag):
        """Build ``(c, a, U, V)`` for the semiseparable solver.

        Complex pairs are interleaved after the real columns, as in
        the JAX package.
        """
        x = atleast_1d(x)
        return _matrices_from_coefficients(
            x, as_tensor(diag, like=x), *self.get_coefficients()
        )

    def dot(self, x, diag, y):
        """Apply ``K @ y`` in O(N J nrhs) for one kernel: ``x (N,)``,
        ``y (N,)`` or ``(N, nrhs)``."""
        from celerite2_torch.ops import matmul_lower, matmul_upper

        x = atleast_1d(x)
        y = as_tensor(y, like=x)
        if y.shape[0] != x.shape[0]:
            raise ValueError("dimension mismatch")
        is_vector = y.ndim == 1
        if is_vector:
            y = y[:, None]
        if y.ndim != 2:
            raise ValueError("'y' can only be a vector or matrix")

        c, a, U, V = self.get_celerite_matrices(x, diag)
        z = a[:, None] * y
        z = z + matmul_lower(x, c, U, V, y)
        z = z + matmul_upper(x, c, U, V, y)
        return z[:, 0] if is_vector else z


def _matrices_from_coefficients(x, diag, ar, cr, ac, bc, cc, dc):
    """Vectorised ``(c, a, U, V)`` construction from ``(*B, n)``
    coefficient tensors and ``x``, ``diag`` of shape ``(..., N)``."""
    ar, cr, ac, bc, cc, dc = (v.to(x) for v in (ar, cr, ac, bc, cc, dc))
    N = x.shape[-1]
    batch = torch.broadcast_shapes(
        x.shape[:-1], diag.shape[:-1], ar.shape[:-1], ac.shape[:-1]
    )
    Jr = ar.shape[-1]
    Jc = ac.shape[-1]

    a = (diag + (ar.sum(-1) + ac.sum(-1))[..., None]).expand(*batch, N)

    cols_c, cols_U, cols_V = [], [], []
    if Jr:
        cols_c.append(cr.expand(*batch, Jr))
        cols_U.append(ar[..., None, :].expand(*batch, N, Jr))
        cols_V.append(x.new_ones(*batch, N, Jr))
    if Jc:
        arg = (dc[..., None, :] * x[..., :, None]).expand(*batch, N, Jc)
        cos, sin = torch.cos(arg), torch.sin(arg)
        U1 = ac[..., None, :] * cos + bc[..., None, :] * sin
        U2 = ac[..., None, :] * sin - bc[..., None, :] * cos
        # interleave the two columns of each complex pair
        cols_U.append(torch.stack([U1, U2], -1).reshape(*batch, N, 2 * Jc))
        cols_V.append(torch.stack([cos, sin], -1).reshape(*batch, N, 2 * Jc))
        cc2 = torch.stack([cc, cc], -1).reshape(*cc.shape[:-1], 2 * Jc)
        cols_c.append(cc2.expand(*batch, 2 * Jc))

    if not cols_c:
        return (
            x.new_zeros(*batch, 0),
            a,
            x.new_zeros(*batch, N, 0),
            x.new_zeros(*batch, N, 0),
        )
    return (
        torch.cat(cols_c, -1),
        a,
        torch.cat(cols_U, -1),
        torch.cat(cols_V, -1),
    )


# =============================================================== algebra


def _no_convolution(*terms):
    if any(isinstance(t, TermConvolution) for t in terms):
        raise TypeError(
            "You cannot perform operations on a TermConvolution, it must "
            "be the outer term in the kernel"
        )


def _outer(u, v, op):
    """``op`` over every pair of the last axes of ``u (*B, n)`` and ``v
    (*B, m)``, flattened to ``(*B, n m)`` with ``u``'s index outer."""
    u, v = torch.broadcast_tensors(u[..., :, None], v[..., None, :])
    return op(u, v).flatten(-2)


def _interleave(x, y):
    """``(x_0, y_0, x_1, y_1, ...)`` along the last axis."""
    return torch.stack([x, y], -1).flatten(-2)


class TermSum(Term):
    """Sum of terms; widths concatenate."""

    _params = ("_terms",)

    def __init__(self, *terms):
        _no_convolution(*terms)
        self._terms = tuple(terms)

    @property
    def terms(self):
        return self._terms

    def to(self, *args, **kwargs):
        return TermSum(*(t.to(*args, **kwargs) for t in self._terms))

    def get_coefficients(self):
        coeffs = [t.get_coefficients() for t in self._terms]
        return tuple(_cat_last(parts) for parts in zip(*coeffs))

    def get_celerite_matrices(self, x, diag):
        # compose the sub-term matrices, so terms that build their own
        # matrices (SHOTerm) stay branchless inside a sum
        x = atleast_1d(x)
        diag = as_tensor(diag, like=x)
        zero = torch.zeros_like(x)
        cs, alist, Us, Vs = [], [], [], []
        for t in self._terms:
            c, a, U, V = t.get_celerite_matrices(x, zero)
            cs.append(c)
            alist.append(a)
            Us.append(U)
            Vs.append(V)
        return (
            _cat_last(cs),
            diag + sum(alist),
            _cat_last(Us),
            _cat_last(Vs),
        )

    def get_value(self, tau):
        return sum(t.get_value(tau) for t in self._terms)

    def get_psd(self, omega):
        return sum(t.get_psd(omega) for t in self._terms)

    @property
    def width(self) -> int:
        return sum(t.width for t in self._terms)


class TermProduct(Term):
    """Product of two terms; the width is J1 J2.

    The closed-form coefficient products:
      real x real       -> real (a1 a2, c1 + c2)
      real x complex    -> complex (amplitudes scale, exponents add)
      complex x complex -> two complex terms at dc1 -+ dc2
    """

    _params = ("term1", "term2")

    def __init__(self, term1, term2):
        _no_convolution(term1, term2)
        self.term1 = term1
        self.term2 = term2

    def get_coefficients(self):
        ar1, cr1, ac1, bc1, cc1, dc1 = self.term1.get_coefficients()
        ar2, cr2, ac2, bc2, cc2, dc2 = self.term2.get_coefficients()

        def mul(u, v):
            return _outer(u, v, torch.mul)

        def add(u, v):
            return _outer(u, v, torch.add)

        # real x real
        ar = mul(ar1, ar2)
        cr = add(cr1, cr2)

        acs, bcs, ccs, dcs = [], [], [], []
        # real x complex (both orders)
        for (arr, crr), (a2, b2, c2, d2) in (
            ((ar1, cr1), (ac2, bc2, cc2, dc2)),
            ((ar2, cr2), (ac1, bc1, cc1, dc1)),
        ):
            acs.append(mul(arr, a2))
            bcs.append(mul(arr, b2))
            ccs.append(add(crr, c2))
            dcs.append(_outer(arr, d2, lambda _, d: d))

        # complex x complex: a product of two damped cosinusoids splits into
        # the difference- and sum-frequency components, interleaved
        aa, bb = mul(ac1, ac2), mul(bc1, bc2)
        ab, ba = mul(ac1, bc2), mul(bc1, ac2)
        ccx = add(cc1, cc2)
        acs.append(_interleave(0.5 * (aa + bb), 0.5 * (aa - bb)))
        bcs.append(_interleave(0.5 * (ba - ab), 0.5 * (ba + ab)))
        ccs.append(_interleave(ccx, ccx))
        dcs.append(_interleave(_outer(dc1, dc2, torch.sub), add(dc1, dc2)))

        return (ar, cr, _cat_last(acs), _cat_last(bcs), _cat_last(ccs),
                _cat_last(dcs))

    @property
    def width(self) -> int:
        return self.term1.width * self.term2.width

    def get_value(self, tau):
        return self.term1.get_value(tau) * self.term2.get_value(tau)

    def get_celerite_matrices(self, x, diag):
        # The Hadamard product of two semiseparable kernels is semiseparable
        # with row-wise Kronecker (Khatri-Rao) factors and summed transport
        # coefficients: K1[n,m] K2[n,m]
        #   = sum_{jk} (U1 kr U2)[n,jk] (V1 kr V2)[m,jk] e^{-(c_j+c_k) dt}.
        # Composing the matrices keeps branchless sub-terms (SHOTerm) exact.
        x = atleast_1d(x)
        diag = as_tensor(diag, like=x)
        zero = torch.zeros_like(x)
        c1, a1, U1, V1 = self.term1.get_celerite_matrices(x, zero)
        c2, a2, U2, V2 = self.term2.get_celerite_matrices(x, zero)
        return (
            _outer(c1, c2, torch.add),
            diag + a1 * a2,
            _outer(U1, U2, torch.mul),
            _outer(V1, V2, torch.mul),
        )


class TermDiff(Term):
    """Second derivative kernel -d^2 k / d tau^2."""

    _params = ("term",)

    def __init__(self, term):
        _no_convolution(term)
        self.term = term

    def get_coefficients(self):
        ar, cr, a, b, c, d = self.term.get_coefficients()
        return (
            -ar * cr**2,
            cr,
            a * (d**2 - c**2) + 2 * b * c * d,
            b * (d**2 - c**2) - 2 * a * c * d,
            c,
            d,
        )


def _damped_exponentials(coeffs):
    """A coefficient 6-tuple as complex pairs ``(w, z, n_real)``: every
    component is ``Re[w exp(-z tau)]`` with ``w = a + i b`` and ``z = c +
    i d`` (b = d = 0 for the first ``n_real``, the real ones), so the
    boxcar closed forms below are written once."""
    ar, cr, ac, bc, cc, dc = coeffs
    w = _cat_last([torch.complex(ar, torch.zeros_like(ar)), torch.complex(ac, bc)])
    z = _cat_last([torch.complex(cr, torch.zeros_like(cr)), torch.complex(cc, dc)])
    return w, z, ar.shape[-1]


def _boxcar_far_amplitudes(w, z, delta):
    """Amplitudes of the boxcar-convolved kernel at lags tau >= delta: each
    ``w`` times ``2 (cosh(z d) - 1) / (z d)^2``; the exponents z are
    unchanged."""
    zd = z * delta
    return 2.0 * w * (torch.cosh(zd) - 1.0) / zd**2


def _boxcar_variance_excess(w, z, delta):
    """``k_conv(0)`` less the sum of the far amplitudes' real parts: the
    overlap of the exposure windows at zero lag, ``2 Re[w (z d - sinh(z
    d))] / (z d)^2`` per component, summed: the diagonal correction of the
    celerite matrices."""
    zd = z * delta
    return 2.0 * torch.sum((w * (zd - torch.sinh(zd)) / zd**2).real, dim=-1)


class TermConvolution(Term):
    """Boxcar (exposure-time) convolution of a term,

        k_conv(tau) = (1/d^2) int_0^d int_0^d k(tau - u + v) du dv,

    which for each component ``Re[w e^{-z tau}]`` is

        tau >= d:  Re[ w' e^{-z tau} ],  w' = 2 w (cosh(zd)-1)/(zd)^2
        tau <  d:  Re[ w (2 (d-tau)/z
                         + (e^{-z(d-tau)} + e^{-z(d+tau)}
                            - 2 e^{-z tau}) / z^2) ] / d^2

    ``delta`` may be batched like the term's parameters.
    """

    _params = ("term", "delta")

    def __init__(self, term, delta):
        self.term = term
        (self.delta,) = _tensors(delta)

    def _delta(self, ndim):
        """delta shaped to broadcast against ``(*B, 1 x ndim)``."""
        return self.delta.reshape(self.delta.shape + (1,) * ndim)

    def get_celerite_matrices(self, x, diag):
        # the semiseparable representation is the far field; of the pairs
        # closer than delta, the diagonal is the part corrected exactly
        x = atleast_1d(x)
        w, z, _ = _damped_exponentials(self.term.get_coefficients())
        excess = _boxcar_variance_excess(w, z, self._delta(1).to(x))
        return Term.get_celerite_matrices(
            self, x, as_tensor(diag, like=x) + excess[..., None])

    def get_coefficients(self):
        ar, cr, ac, bc, cc, dc = self.term.get_coefficients()
        w, z, n_real = _damped_exponentials((ar, cr, ac, bc, cc, dc))
        wp = _boxcar_far_amplitudes(w, z, self._delta(1).to(ar))
        return (wp[..., :n_real].real, cr, wp[..., n_real:].real,
                wp[..., n_real:].imag, cc, dc)

    def get_psd(self, omega):
        omega = atleast_1d(omega)
        psd0 = self.term.get_psd(omega)
        arg = 0.5 * self._delta(omega.ndim).to(omega) * omega
        safe = torch.where(arg == 0.0, torch.ones_like(arg), arg)
        sinc = torch.where(arg == 0.0, torch.ones_like(arg), torch.sin(arg) / safe)
        return psd0 * sinc**2

    def get_value(self, tau0):
        tau0 = torch.abs(atleast_1d(tau0))
        w, z, _ = (x if isinstance(x, int) else _lift(x, tau0.ndim)
                   for x in _damped_exponentials(self.term.get_coefficients()))
        d = self._delta(tau0.ndim + 1).to(tau0)
        tau = tau0[..., None]

        far = torch.sum(
            (_boxcar_far_amplitudes(w, z, d) * torch.exp(-z * tau)).real, dim=-1)

        gap = d - tau
        near_per = w * (
            2.0 * gap / z
            + (torch.exp(-z * gap) + torch.exp(-z * (d + tau))
               - 2.0 * torch.exp(-z * tau)) / z**2
        )
        near = torch.sum(near_per.real, dim=-1) / d[..., 0] ** 2
        return torch.where(tau0 >= d[..., 0], far, near)


# ====================================================== primitive terms


class RealTerm(Term):
    """k(tau) = a exp(-c tau)."""

    _params = ("a", "c")

    def __init__(self, *, a, c):
        self.a, self.c = _tensors(a, c)

    def get_coefficients(self):
        a, c = torch.broadcast_tensors(self.a, self.c)
        e = a.new_zeros(a.shape + (0,))
        return a[..., None], c[..., None], e, e, e, e


class ComplexTerm(Term):
    """k(tau) = exp(-c tau) (a cos(d tau) + b sin(d tau))."""

    _params = ("a", "b", "c", "d")

    def __init__(self, *, a, b, c, d):
        self.a, self.b, self.c, self.d = _tensors(a, b, c, d)

    def get_coefficients(self):
        a, b, c, d = torch.broadcast_tensors(self.a, self.b, self.c, self.d)
        e = a.new_zeros(a.shape + (0,))
        return e, e, a[..., None], b[..., None], c[..., None], d[..., None]


def resolve_parameter_spec(spec, kwargs):
    """Resolve alternative parameterizations from a declarative table.

    ``spec`` rows are ``(primary, alternatives)`` where ``alternatives``
    maps each alternate keyword to a converter
    ``(resolved_so_far: dict, value) -> primary_value``; converters may
    depend on primaries resolved by EARLIER rows only.  Exactly one
    spelling per row must appear in ``kwargs``; consumed names are
    popped, so the caller can detect leftover unknown keywords.  Returns
    the dict of primary values.
    """
    resolved = {}
    device = first_device(*kwargs.values())
    for primary, alternatives in spec:
        spellings = (primary, *alternatives)
        present = [name for name in spellings if name in kwargs]
        if len(present) != 1:
            raise ValueError(
                f"exactly one of {sorted(spellings)} must be defined"
            )
        (name,) = present
        value = as_tensor(kwargs.pop(name), device=device)
        if name != primary:
            value = alternatives[name](resolved, value)
        resolved[primary] = value
    return resolved


class SHOTerm(Term):
    """Stochastically-driven damped harmonic oscillator.

    Supports alternative parameterizations ``rho = 2 pi / w0``,
    ``tau = 2 Q / w0``, ``sigma = sqrt(S0 w0 Q)``.

    Both damping regimes have width J=2 (two real terms when overdamped,
    one complex pair when underdamped), so the celerite matrices are
    selected elementwise with ``torch.where``.
    """

    _params = ("w0", "Q", "S0", "eps")

    __parameter_spec__ = (
        ("w0", {"rho": lambda p, rho: 2 * math.pi / rho}),
        ("Q", {"tau": lambda p, tau: 0.5 * p["w0"] * tau}),
        ("S0", {"sigma": lambda p, sigma: sigma**2 / (p["w0"] * p["Q"])}),
    )

    def __init__(self, *, eps=1e-5, **params):
        resolved = resolve_parameter_spec(self.__parameter_spec__, params)
        if params:
            raise TypeError(
                f"unexpected SHOTerm parameters: {sorted(params)}"
            )
        for name, value in resolved.items():
            setattr(self, name, value)
        self.eps = as_tensor(eps, device=first_device(*resolved.values()))

    def _cast(self, like):
        return tuple(getattr(self, p).to(like) for p in self._params)

    # -- the two regimes, each as width-2 coefficient sets ------------
    # The max(., eps) clamps keep the branch that is NOT taken finite
    # and differentiable: torch.where's backward multiplies its zero
    # cotangent by that branch's derivative, and 0 * inf is NaN.
    @staticmethod
    def _overdamped(w0, Q, S0, eps):
        f = torch.sqrt(torch.maximum(1.0 - 4.0 * Q**2, eps))
        amp = 0.5 * S0 * w0 * Q
        ar = amp[..., None] * torch.stack([1.0 + 1.0 / f, 1.0 - 1.0 / f], -1)
        cr = (0.5 * w0 / Q)[..., None] * torch.stack([1.0 - f, 1.0 + f], -1)
        return ar, cr

    @staticmethod
    def _underdamped(w0, Q, S0, eps):
        f = torch.sqrt(torch.maximum(4.0 * Q**2 - 1.0, eps))
        a = S0 * w0 * Q
        c = 0.5 * w0 / Q
        return a[..., None], (a / f)[..., None], c[..., None], (c * f)[..., None]

    def get_coefficients(self):
        # The coefficient *structure* depends on the damping regime, so
        # it is defined only when every batch entry is in the same one.
        w0, Q, S0, eps = torch.broadcast_tensors(
            *(getattr(self, p) for p in self._params)
        )
        over = Q < 0.5
        e = Q.new_zeros(Q.shape + (0,))
        if bool(over.all()):
            ar, cr = self._overdamped(w0, Q, S0, eps)
            return ar, cr, e, e, e, e
        if not bool(over.any()):
            ac, bc, cc, dc = self._underdamped(w0, Q, S0, eps)
            return e, e, ac, bc, cc, dc
        raise ValueError(
            "SHOTerm.get_coefficients needs every batch entry in the same "
            "damping regime; use get_value/get_psd/get_celerite_matrices"
        )

    @property
    def width(self) -> int:
        return 2

    def get_value(self, tau):
        tau = torch.abs(atleast_1d(tau))
        w0, Q, S0, eps = self._cast(tau)
        ar, cr = (_lift(x, tau.ndim) for x in self._overdamped(w0, Q, S0, eps))
        ac, bc, cc, dc = (
            _lift(x, tau.ndim) for x in self._underdamped(w0, Q, S0, eps)
        )
        tau = tau[..., None]
        over = torch.sum(ar * torch.exp(-cr * tau), dim=-1)
        arg = dc * tau
        under = torch.sum(
            torch.exp(-cc * tau) * (ac * torch.cos(arg) + bc * torch.sin(arg)),
            dim=-1,
        )
        is_over = (Q < 0.5).reshape(Q.shape + (1,) * (tau.ndim - 1))
        return torch.where(is_over, over, under)

    def get_psd(self, omega):
        # closed form, the same in both regimes:
        # S(w) = sqrt(2/pi) S0 w0^4 / ((w^2-w0^2)^2 + w0^2 w^2 / Q^2)
        omega = atleast_1d(omega)
        w0, Q, S0, _ = (
            x.reshape(x.shape + (1,) * omega.ndim) for x in self._cast(omega)
        )
        w2 = omega**2
        w02 = w0**2
        return (
            math.sqrt(2.0 / math.pi)
            * S0
            * w02**2
            / ((w2 - w02) ** 2 + w02 * w2 / Q**2)
        )

    def get_celerite_matrices(self, x, diag):
        x = atleast_1d(x)
        diag = as_tensor(diag, like=x)
        w0, Q, S0, eps = self._cast(x)
        ar, cr = self._overdamped(w0, Q, S0, eps)
        e = ar.new_zeros(ar.shape[:-1] + (0,))
        c_o, a_o, U_o, V_o = _matrices_from_coefficients(
            x, diag, ar, cr, e, e, e, e
        )
        ac, bc, cc, dc = self._underdamped(w0, Q, S0, eps)
        c_u, a_u, U_u, V_u = _matrices_from_coefficients(
            x, diag, e, e, ac, bc, cc, dc
        )
        cond = Q < 0.5
        return (
            torch.where(cond[..., None], c_o, c_u),
            torch.where(cond[..., None], a_o, a_u),
            torch.where(cond[..., None, None], U_o, U_u),
            torch.where(cond[..., None, None], V_o, V_u),
        )


class Matern32Term(Term):
    """Approximate Matern-3/2 kernel."""

    _params = ("sigma", "rho", "eps")

    def __init__(self, *, sigma, rho, eps=0.01):
        self.sigma, self.rho, self.eps = _tensors(sigma, rho, eps)

    def get_coefficients(self):
        sigma, rho, eps = torch.broadcast_tensors(self.sigma, self.rho, self.eps)
        w0 = math.sqrt(3.0) / rho
        S0 = sigma**2 / w0
        e = sigma.new_zeros(sigma.shape + (0,))
        return (
            e,
            e,
            (w0 * S0)[..., None],
            (w0**2 * S0 / eps)[..., None],
            w0[..., None],
            eps[..., None],
        )


class RotationTerm(Term):
    """Stellar-rotation model: an SHO at the period P plus one at P/2.

    Both modes are underdamped by construction (Q >= 1/2 + Q0 > 1/2), so
    the term is a sum of two complex pairs, width 4.
    """

    _params = ("sigma", "period", "Q0", "dQ", "f")

    def __init__(self, *, sigma, period, Q0, dQ, f):
        self.sigma, self.period, self.Q0, self.dQ, self.f = _tensors(
            sigma, period, Q0, dQ, f
        )

    def _sho_terms(self):
        amp = self.sigma**2 / (1 + self.f)

        Q1 = 0.5 + self.Q0 + self.dQ
        w1 = 4 * math.pi * Q1 / (self.period * torch.sqrt(4 * Q1**2 - 1))
        S1 = amp / (w1 * Q1)

        Q2 = 0.5 + self.Q0
        w2 = 8 * math.pi * Q2 / (self.period * torch.sqrt(4 * Q2**2 - 1))
        S2 = self.f * amp / (w2 * Q2)

        return SHOTerm(S0=S1, w0=w1, Q=Q1), SHOTerm(S0=S2, w0=w2, Q=Q2)

    @property
    def terms(self):
        return self._sho_terms()

    @property
    def width(self) -> int:
        return 4

    # The coefficients mix every parameter, so the parameters first take
    # the input's dtype and device (as SHOTerm's do): a CUDA sigma with a
    # float period would otherwise meet on two devices.
    def get_celerite_matrices(self, x, diag):
        x = atleast_1d(x)
        return Term.get_celerite_matrices(self.to(x), x, diag)

    def get_value(self, tau):
        tau = atleast_1d(tau)
        return Term.get_value(self.to(tau), tau)

    def get_psd(self, omega):
        omega = atleast_1d(omega)
        return Term.get_psd(self.to(omega), omega)

    def get_coefficients(self):
        # the modes' own eps (a float default) follows sigma's device
        modes = [
            SHOTerm._underdamped(*torch.broadcast_tensors(*t._cast(self.sigma)))
            for t in self._sho_terms()
        ]
        e = modes[0][0].new_zeros(modes[0][0].shape[:-1] + (0,))
        return (e, e) + tuple(_cat_last(parts) for parts in zip(*modes))


class OriginalCeleriteTerm(Term):
    """Wrap a celerite-v1 term: any object whose ``get_all_coefficients()``
    returns ``(ar, cr, ac, bc, cc, dc)``.  The coefficients are read once
    and held as the term's parameters."""

    _params = ("ar", "cr", "ac", "bc", "cc", "dc")

    def __init__(self, term):
        self.ar, self.cr, self.ac, self.bc, self.cc, self.dc = (
            atleast_1d(c) for c in _tensors(*term.get_all_coefficients())
        )

    def get_coefficients(self):
        return (self.ar, self.cr, self.ac, self.bc, self.cc, self.dc)
