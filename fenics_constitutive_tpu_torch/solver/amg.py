"""Smoothed-aggregation AMG preconditioner for any mesh.

The port of ``fenics_constitutive_tpu.solver.amg``. The hierarchy is built
ONCE on the host (numpy/scipy):

- assemble the constant-coefficient ELASTIC operator (a spectrally
  equivalent surrogate of the consistent tangent, which softening would make
  indefinite) and eliminate the Dirichlet dofs;
- aggregate nodes: box bucketing of the coordinates on large fine levels,
  a greedy two-pass walk of the strength-filtered node graph otherwise;
- tentative prolongation from the rigid-body modes by batched QR, smoothed
  with damped Jacobi (classic smoothed aggregation, Vanek et al.);
- Galerkin products ``A_{l+1} = P^T A_l P`` and a dense coarsest inverse.

Every level operator, prolongation and restriction is then frozen in one of
two level formats, which compute the same V-cycle:

- ``spmv="ell"`` (the default, as in the JAX package): fixed-width ELL rows,
  ``AmgPreconditioner``, on node-major dof vectors. A level apply is a
  gather and a row sum, ``(vals * v[cols]).sum(1)``, in plain PyTorch (the
  JAX package runs it outside any Pallas kernel too). ``PackedSimulation``
  takes it off the card, where it is the plain SpMV.
- ``spmv="windowed"``: windowed BSR plans (``ops/windowed_bsr.py``) on
  banded node orders, ``WindowedAmgPreconditioner``; on the card every
  level apply is the CUDA kernel K6. With the windowed engine's RCM order
  the V-cycle consumes the engine's internal vectors directly
  (``wrap_internal``); ``forward`` takes node-major vectors, which is how
  ``PackedSimulation`` serves the other engines on the card.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from ..ops import mandel
from ..ops.mandel import Constraint
from ..ops.structured import _matmul

__all__ = ["AmgPreconditioner", "WindowedAmgPreconditioner", "build_amg"]


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------


def _moduli_to_E_nu(mu: float, kappa: float) -> tuple[float, float]:
    E = 9.0 * kappa * mu / (3.0 * kappa + mu)
    nu = (3.0 * kappa - 2.0 * mu) / (2.0 * (3.0 * kappa + mu))
    return E, nu


def space_constraint(space) -> Constraint:
    """The stress/strain constraint implied by the space's dimensions."""
    gdim = space.mesh.gdim
    vs = space.value_size
    if gdim == 3:
        return Constraint.FULL
    if gdim == 2:
        if vs != 2:
            msg = f"the AMG elastic surrogate needs a vector space on 2D meshes, got value_size={vs}"
            raise ValueError(msg)
        return Constraint.PLANE_STRAIN
    if vs != 1:
        msg = f"the AMG elastic surrogate needs a scalar space on 1D meshes, got value_size={vs}"
        raise ValueError(msg)
    return Constraint.UNIAXIAL_STRESS


def _assemble_elastic_csr(space, q_degree: int, C_el: np.ndarray):
    """CSR of the elastic operator K = sum_e B^T C B w|J| (host, chunked)."""
    import scipy.sparse as sp

    from ..fem.kinematics import precompute_geometry

    geo = precompute_geometry(space, q_degree)
    dN, w = geo.dN_dx, geo.w_detJ  # [C, Q, n, g], [C, Q]
    M = mandel._mandel_matrix_map(space_constraint(space))  # [s, g, g]
    vs = space.value_size
    ncell, Q, n, _g = dN.shape
    nd = n * vs
    dofs = np.asarray(space.dofmap).reshape(ncell, nd)  # [C, n*vs]

    rows_all, cols_all, vals_all = [], [], []
    chunk = max(1, 20_000_000 // (Q * C_el.shape[0] * nd))
    for c0 in range(0, ncell, chunk):
        dNc = dN[c0 : c0 + chunk]
        wc = w[c0 : c0 + chunk]
        # B[c,q,s,(a j)] = M[s,i,j] dN[c,q,a,i]
        B = np.einsum("sij,cqai->cqsaj", M, dNc)
        B = B.reshape(B.shape[0], Q, C_el.shape[0], nd)
        K = np.einsum("cq,cqsa,st,cqtb->cab", wc, B, C_el, B, optimize=True)
        d = dofs[c0 : c0 + chunk]
        rows_all.append(np.repeat(d, nd, axis=1).ravel())
        cols_all.append(np.tile(d, (1, nd)).ravel())
        vals_all.append(K.ravel())
    A = sp.coo_matrix(
        (np.concatenate(vals_all), (np.concatenate(rows_all), np.concatenate(cols_all))),
        shape=(space.ndofs, space.ndofs),
    ).tocsr()
    A.sum_duplicates()
    return A


def _eliminate_dirichlet(A, free: np.ndarray):
    """D_f A D_f + I_c: constrained dofs become identity rows/cols."""
    import scipy.sparse as sp

    d = free.astype(np.float64)
    Df = sp.diags(d)
    return (Df @ A @ Df + sp.diags(1.0 - d)).tocsr()


def _node_adjacency(A, vs: int, theta: float = 0.0):
    """Node graph from the dof CSR's block sparsity (CSR [nn, nn] 0/1).

    ``theta > 0`` applies symmetric strength-of-connection dropping on the
    vs-by-vs node blocks: edge (i, j) survives iff
    ``|A_ij|_F >= theta * sqrt(|A_ii|_F |A_jj|_F)``."""
    import scipy.sparse as sp

    nn_ = A.shape[0] // vs
    coo = A.tocoo()
    keep = coo.data != 0.0
    r = coo.row[keep] // vs
    c = coo.col[keep] // vs
    if theta > 0.0:
        # block Frobenius norms squared: N_ij = sum over the block of a^2
        N = sp.coo_matrix((coo.data[keep] ** 2, (r, c)), shape=(nn_, nn_)).tocsr()
        N.sum_duplicates()
        d = np.sqrt(np.maximum(N.diagonal(), 0.0))
        Nc = N.tocoo()
        strong = Nc.data >= (theta**2) * d[Nc.row] * d[Nc.col]
        r, c = Nc.row[strong], Nc.col[strong]
    G = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(nn_, nn_)).tocsr()
    G.sum_duplicates()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


def _aggregate_geometric(
    coords: np.ndarray, factor: float = 3.0, h_axes: np.ndarray | None = None
) -> np.ndarray:
    """Vectorized box aggregation: bucket nodes into boxes of ~factor*h.

    ``h_axes`` is the per-axis node spacing; on stretched meshes the box then
    spans ~factor cells along the small (strongly coupled) axis and a single
    cell along the large axes. Empty boxes vanish in the unique() compaction."""
    n, g = coords.shape
    lo = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - lo, 1e-300)
    h_density = float((np.prod(span) / max(n, 1)) ** (1.0 / g))
    if h_axes is None:
        size = np.full(g, factor * h_density)
    else:
        h = np.maximum(np.asarray(h_axes, np.float64), 1e-300)
        size = np.maximum(h, factor * min(h.min(), h_density))
    keys = np.floor((coords - lo) / size).astype(np.int64)
    _, agg = np.unique(keys, axis=0, return_inverse=True)
    return agg.ravel()


def _aggregate(G) -> np.ndarray:
    """Greedy two-pass aggregation on a node graph. Returns agg id per node."""
    nn_ = G.shape[0]
    agg = np.full(nn_, -1, np.int64)
    indptr, indices = G.indptr, G.indices
    n_agg = 0
    # pass 1: seed aggregates from nodes whose neighbourhood is untouched
    for i in range(nn_):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    # pass 2: attach leftovers to the most-connected neighbouring aggregate
    for i in range(nn_):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        owned = agg[nbrs]
        owned = owned[owned != -1]
        if len(owned):
            agg[i] = np.bincount(owned).argmax()
        else:  # isolated node: own aggregate
            agg[i] = n_agg
            n_agg += 1
    return agg


def _rigid_body_modes(coords: np.ndarray, vs: int) -> np.ndarray:
    """Near-nullspace of the elastic operator: translations + rotations,
    [nn*vs, nb] with nb = 6 (3D), 3 (2D), 1 (1D)."""
    nn_ = coords.shape[0]
    x = coords - coords.mean(axis=0)
    if vs == 1:
        return np.ones((nn_, 1))
    if vs == 2:
        B = np.zeros((nn_, 2, 3))
        B[:, 0, 0] = 1.0
        B[:, 1, 1] = 1.0
        B[:, 0, 2] = -x[:, 1]
        B[:, 1, 2] = x[:, 0]
        return B.reshape(nn_ * 2, 3)
    B = np.zeros((nn_, 3, 6))
    for j in range(3):
        B[:, j, j] = 1.0
    # rotations about z, x, y
    B[:, 0, 3] = -x[:, 1]
    B[:, 1, 3] = x[:, 0]
    B[:, 1, 4] = -x[:, 2]
    B[:, 2, 4] = x[:, 1]
    B[:, 0, 5] = x[:, 2]
    B[:, 2, 5] = -x[:, 0]
    return B.reshape(nn_ * 3, 6)


def _tentative_P(agg: np.ndarray, B: np.ndarray, bs: int):
    """Nullspace-preserving tentative prolongation via per-aggregate QR.

    ``B`` [nn*bs, nb] is the current level's near-nullspace. Returns
    (P [nn*bs, n_agg*nb], B_coarse [n_agg*nb, nb]) with P @ B_coarse = B
    restricted to each aggregate."""
    import scipy.sparse as sp

    nn_ = len(agg)
    nb = B.shape[1]
    n_agg = int(agg.max()) + 1
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=n_agg)
    maxm = int(counts.max())
    # padded member table [n_agg, maxm] of node ids (pad = -1)
    members = np.full((n_agg, maxm), -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(nn_) - starts[agg[order]]
    members[agg[order], pos] = order
    valid = members >= 0  # [n_agg, maxm]

    Bn = B.reshape(nn_, bs, nb)
    T = np.where(
        valid[:, :, None, None], Bn[np.clip(members, 0, None)], 0.0
    ).reshape(n_agg, maxm * bs, nb)
    Q, R = np.linalg.qr(T)  # batched reduced QR: Q [n_agg, maxm*bs, k<=nb]
    k = Q.shape[2]
    # drop numerically dead modes (all-constrained aggregates etc.)
    diag = np.abs(R[:, np.arange(k), np.arange(k)])
    dead = diag < 1e-12 * max(1.0, float(np.abs(R).max()))
    Qm = np.where(dead[:, None, :], 0.0, Q)
    Rm = np.where(dead[:, :, None], 0.0, R)
    if k < nb:  # tiny aggregates: pad coarse block to nb
        Qm = np.pad(Qm, ((0, 0), (0, 0), (0, nb - k)))
        Rm = np.pad(Rm, ((0, 0), (0, nb - k), (0, 0)))

    rows = (members[:, :, None] * bs + np.arange(bs)[None, None, :]).reshape(
        n_agg, maxm * bs
    )
    cols = np.arange(n_agg)[:, None] * nb + np.arange(nb)[None, :]  # [n_agg, nb]
    r_idx = np.broadcast_to(rows[:, :, None], Qm.shape)
    c_idx = np.broadcast_to(cols[:, None, :], Qm.shape)
    keep = np.broadcast_to(
        valid[:, :, None].repeat(bs, axis=1).reshape(n_agg, maxm * bs, 1), Qm.shape
    ) & (Qm != 0.0)
    P = sp.coo_matrix(
        (Qm[keep], (r_idx[keep], c_idx[keep])), shape=(nn_ * bs, n_agg * nb)
    ).tocsr()
    return P, Rm.reshape(n_agg * nb, nb)


def _rho_DinvA(A, n_iter: int = 12) -> float:
    """Power-iteration estimate of rho(D^-1 A) (host).

    The start vector is drawn from numpy's generator with the fixed seed 0,
    as in the JAX package, so both packages build the same hierarchy."""
    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(n_iter):
        x = (A @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0:
            return 2.0
        lam = nrm
        x /= nrm
    return float(lam) * 1.05


def _to_ell(A) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> fixed-width ELL (vals [n, k] float64, cols [n, k] int64); a
    row's unused slots hold 0 at column 0."""
    A = A.tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    n = A.shape[0]
    nnz_row = np.diff(A.indptr)
    k = max(1, int(nnz_row.max()))
    vals = np.zeros((n, k))
    cols = np.zeros((n, k), np.int64)
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(len(A.data)) - A.indptr[rows]
    vals[rows, pos] = A.data
    cols[rows, pos] = A.indices
    return vals, cols


def _ell_matvec(vals: torch.Tensor, cols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A v for an ELL level: a gather and a sum over each row's slots in
    slot order (no atomics)."""
    return (vals * v[cols]).sum(dim=1)


# ---------------------------------------------------------------------------
# device-side V-cycles
# ---------------------------------------------------------------------------


class AmgPreconditioner(nn.Module):
    """Callable z = M(r): one V(nu, nu) cycle of the elastic SA hierarchy on
    node-major dof vectors, every level SpMV an ELL gather and row sum.

    Buffers per level l: ``A_vals_l``/``A_cols_l`` (the level operator, all
    but the coarsest), ``P_vals_l``/``P_cols_l`` (coarse -> fine),
    ``R_vals_l``/``R_cols_l`` (fine -> coarse, P^T), ``dinv_l`` (inverse
    Jacobi diagonal); ``coarse_inv``, the dense coarsest inverse.
    ``A_ell``/``P_ell``/``R_ell`` give the levels as ``(vals, cols)`` pairs.
    """

    coarse_inv: torch.Tensor

    def __init__(self, *, A_ell, P_ell, R_ell, dinv, coarse_inv, omega: float, nu: int):
        super().__init__()
        for name, levels in (("A", A_ell), ("P", P_ell), ("R", R_ell)):
            for lvl, (vals, cols) in enumerate(levels):
                self.register_buffer(f"{name}_vals_{lvl}", vals)
                self.register_buffer(f"{name}_cols_{lvl}", cols)
        for lvl, d in enumerate(dinv):
            self.register_buffer(f"dinv_{lvl}", d)
        self.register_buffer("coarse_inv", coarse_inv)
        self.omega, self.nu, self.n_levels = float(omega), int(nu), len(dinv) + 1
        #: host seconds of the build: assembly and hierarchy, freeze, upload
        self.build_seconds: dict[str, float] = {}

    def _ell(self, name: str) -> tuple:
        return tuple((getattr(self, f"{name}_vals_{lvl}"), getattr(self, f"{name}_cols_{lvl}"))
                     for lvl in range(self.n_levels - 1))

    @property
    def A_ell(self) -> tuple:
        return self._ell("A")

    @property
    def P_ell(self) -> tuple:
        return self._ell("P")

    @property
    def R_ell(self) -> tuple:
        return self._ell("R")

    def _cycle(self, lvl: int, b: torch.Tensor) -> torch.Tensor:
        if lvl == self.n_levels - 1:
            return _matmul(self.coarse_inv, b[:, None])[:, 0]
        Av, Ac = getattr(self, f"A_vals_{lvl}"), getattr(self, f"A_cols_{lvl}")
        di = getattr(self, f"dinv_{lvl}")
        # zero-start pre-smoothing: the first sweep is x = omega D^-1 b
        x = self.omega * di * b
        for _ in range(self.nu - 1):
            x = x + self.omega * di * (b - _ell_matvec(Av, Ac, x))
        r = b - _ell_matvec(Av, Ac, x)
        bc = _ell_matvec(getattr(self, f"R_vals_{lvl}"), getattr(self, f"R_cols_{lvl}"), r)
        xc = self._cycle(lvl + 1, bc)
        x = x + _ell_matvec(getattr(self, f"P_vals_{lvl}"), getattr(self, f"P_cols_{lvl}"), xc)
        for _ in range(self.nu):
            x = x + self.omega * di * (b - _ell_matvec(Av, Ac, x))
        return x

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r.to(self.coarse_inv.dtype)).to(r.dtype)


class WindowedAmgPreconditioner(nn.Module):
    """Callable z = M(r): one V(nu, nu) cycle of the elastic SA hierarchy,
    every level SpMV a windowed BSR apply (ops/windowed_bsr.py).

    Level vectors are component-major over banded node orders (the fine
    level uses the mesh RCM, so it consumes ``WindowedGeometry`` internal
    vectors directly through :meth:`wrap_internal`). ``__call__`` takes and
    returns node-major dof vectors of the space.

    Submodules ``A_win``/``P_win``/``R_win`` (ModuleLists of WindowedBsr);
    buffers ``dinv_<l>`` (inverse Jacobi diagonals, internal layout),
    ``coarse_inv`` (the COMPACT dense coarsest inverse [bsc*nc, bsc*nc]),
    ``perm_dev``/``invperm_dev`` (fine nodes old <-> new).
    """

    coarse_inv: torch.Tensor
    perm_dev: torch.Tensor
    invperm_dev: torch.Tensor

    def __init__(self, *, A_win, P_win, R_win, dinv_int, coarse_inv, nc: int, bsc: int,
                 NPc: int, perm_dev, invperm_dev, omega: float, nu: int, n_levels: int,
                 vs: int, n_nodes0: int, NP0: int):
        super().__init__()
        self.A_win = nn.ModuleList(A_win)
        self.P_win = nn.ModuleList(P_win)
        self.R_win = nn.ModuleList(R_win)
        for lvl, d in enumerate(dinv_int):
            self.register_buffer(f"dinv_{lvl}", d)
        self.register_buffer("coarse_inv", coarse_inv)
        self.register_buffer("perm_dev", perm_dev)
        self.register_buffer("invperm_dev", invperm_dev)
        self.nc, self.bsc, self.NPc = nc, bsc, NPc
        self.omega, self.nu, self.n_levels = float(omega), int(nu), n_levels
        self.vs, self.n_nodes0, self.NP0 = vs, n_nodes0, NP0
        #: host seconds of the build: assembly and hierarchy, freeze, upload
        self.build_seconds: dict[str, float] = {}

    def _cycle(self, lvl: int, b: torch.Tensor) -> torch.Tensor:
        if lvl == self.n_levels - 1:
            # compact dense solve: slice the real coarse dofs out of the
            # tile-padded level vector, apply, pad the result back
            b2 = b.reshape(self.bsc, self.NPc)[:, : self.nc].reshape(-1)
            x2 = _matmul(self.coarse_inv, b2[:, None])[:, 0]
            out = b.new_zeros((self.bsc, self.NPc))
            out[:, : self.nc] = x2.reshape(self.bsc, self.nc)
            return out.reshape(-1)
        A = self.A_win[lvl]
        di = getattr(self, f"dinv_{lvl}")
        # zero-start pre-smoothing: the first sweep is x = omega D^-1 b
        x = self.omega * di * b
        for _ in range(self.nu - 1):
            x = x + self.omega * di * (b - A.matvec(x))
        r = b - A.matvec(x)
        xc = self._cycle(lvl + 1, self.R_win[lvl].matvec(r))
        x = x + self.P_win[lvl].matvec(xc)
        for _ in range(self.nu):
            x = x + self.omega * di * (b - A.matvec(x))
        return x

    # -- layout plumbing -------------------------------------------------------

    def to_internal(self, r: torch.Tensor) -> torch.Tensor:
        r2 = r.reshape(self.n_nodes0, self.vs).T[:, self.invperm_dev]
        out = r.new_zeros((self.vs, self.NP0))
        out[:, : self.n_nodes0] = r2
        return out.reshape(-1)

    def from_internal(self, zi: torch.Tensor) -> torch.Tensor:
        z2 = zi.reshape(self.vs, self.NP0)
        return z2[:, self.perm_dev].T.reshape(-1)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        dt = self.coarse_inv.dtype
        zi = self._cycle(0, self.to_internal(r).to(dt))
        return self.from_internal(zi).to(r.dtype)

    def wrap_internal(self, m_pad: int):
        """M(r) on WindowedGeometry internal vectors [vs * m_pad] built with
        the SAME node permutation: a static slice/pad, no index ops. The
        returned callable carries ``internal_layout = True``."""

        def apply(r_int: torch.Tensor) -> torch.Tensor:
            r2 = r_int.reshape(self.vs, m_pad)
            if m_pad >= self.NP0:
                ri = r2[:, : self.NP0]
            else:
                ri = torch.nn.functional.pad(r2, (0, self.NP0 - m_pad))
            zi = self._cycle(0, ri.reshape(-1).to(self.coarse_inv.dtype))
            z2 = zi.reshape(self.vs, self.NP0)
            if m_pad >= self.NP0:
                z2 = torch.nn.functional.pad(z2, (0, m_pad - self.NP0))
            else:
                z2 = z2[:, :m_pad]
            return z2.reshape(-1).to(r_int.dtype)

        apply.internal_layout = True
        return apply


def build_amg(
    space,
    mu: float,
    kappa: float,
    free_mask,
    *,
    device="cuda",
    dtype: torch.dtype,
    q_degree: int = 2,
    omega: float = 0.6,
    nu: int = 2,
    max_coarse: int = 600,
    max_levels: int = 12,
    smooth_prolongation: bool = True,
    aggregation: str = "auto",
    geometric_factor: float = 2.6,
    strength_theta: float = 0.06,
    spmv: str = "ell",
    node_perm=None,
    select_passes: int = 1,
    tile_rows: int = 1024,
) -> AmgPreconditioner | WindowedAmgPreconditioner:
    """Build the smoothed-aggregation elastic hierarchy for ``space``.

    Args:
        space: displacement FunctionSpace on any mesh (tet/tri/hex/quad).
        mu/kappa: elastic moduli of the hierarchy operator.
        free_mask: bool [ndofs], False at Dirichlet dofs.
        smooth_prolongation: P = (I - 4/(3 rho) D^-1 A) P_tent; False keeps
            plain aggregation.
        aggregation: fine-level strategy. "graph" = greedy two-pass walk on
            the strength-filtered stiffness graph; "geometric" = box
            bucketing of the node coordinates; "auto" = geometric above 8000
            nodes. Coarse levels always use the graph walk.
        geometric_factor: box edge in units of the per-axis cell extent.
        strength_theta: strength-of-connection threshold of the graph walk.
        spmv: the level format: "ell" (``AmgPreconditioner``, node-major
            vectors) or "windowed" (``WindowedAmgPreconditioner``, windowed
            BSR plans that K6 applies on the card).
        node_perm, select_passes, tile_rows: the windowed format's options.
            node_perm: fine node ordering (old -> new) of the level plans,
            e.g. the windowed geometry's ``ex.perm``; default the mesh RCM.
            select_passes: 1 rounds float32 level inputs to bfloat16 in the
            column select (the default, as in the JAX package); 3 is exact.
            tile_rows: row nodes per BSR row tile.

    ``build_seconds`` of the result: "hierarchy" (assembly, aggregation and
    Galerkin products on the host), "freeze" (the level format, on the host)
    and "upload" (every level to the device in one step).
    """
    import scipy.sparse as sp

    if spmv not in ("ell", "windowed"):
        msg = f"spmv must be 'ell' or 'windowed', got {spmv!r}"
        raise ValueError(msg)
    if aggregation not in ("auto", "graph", "geometric"):
        msg = f"aggregation must be 'auto'|'graph'|'geometric', got {aggregation!r}"
        raise ValueError(msg)
    t0 = time.perf_counter()
    vs = space.value_size
    E, nu_p = _moduli_to_E_nu(float(mu), float(kappa))
    C_el = mandel.get_elastic_tangent(E, nu_p, space_constraint(space))
    A0 = _assemble_elastic_csr(space, q_degree, C_el)
    free = np.asarray(free_mask, bool)
    A0 = _eliminate_dirichlet(A0, free)

    # near-nullspace: rigid body modes, zeroed at constrained dofs so coarse
    # corrections never touch Dirichlet rows
    B = _rigid_body_modes(np.asarray(space.dof_coords), vs)
    B = B * free.astype(np.float64)[:, None]

    coords0 = np.asarray(space.dof_coords, np.float64)
    use_geometric = aggregation == "geometric" or (
        aggregation == "auto" and coords0.shape[0] > 8000
    )

    A_levels = [A0]
    P_levels: list = []
    agg_levels: list = []
    bs_levels = [vs]
    bs = vs  # dofs per "node" at the current level (nb on coarse levels)
    while A_levels[-1].shape[0] > max_coarse and len(A_levels) < max_levels:
        A = A_levels[-1]
        if use_geometric and len(A_levels) == 1:
            pts = np.asarray(space.mesh.nodes, np.float64)[np.asarray(space.mesh.cells)]
            h_axes = np.median(pts.max(axis=1) - pts.min(axis=1), axis=0)
            agg = _aggregate_geometric(coords0, geometric_factor, h_axes)
        else:
            agg = _aggregate(_node_adjacency(A, bs, strength_theta))
        P, B = _tentative_P(agg, B, bs)
        bs = B.shape[1]
        if P.shape[1] >= A.shape[0]:  # aggregation stalled
            break
        agg_levels.append(np.asarray(agg))
        bs_levels.append(bs)
        if smooth_prolongation:
            d = A.diagonal()
            d = np.where(d > 0, d, 1.0)
            w_p = 4.0 / (3.0 * _rho_DinvA(A))
            P = (P - sp.diags(w_p / d) @ (A @ P)).tocsr()
        A_next = (P.T @ A @ P).tocsr()
        A_next.sum_duplicates()
        # dead coarse dofs (dropped QR modes) leave zero rows: pin them
        dz = A_next.diagonal() == 0.0
        if dz.any():
            A_next = (A_next + sp.diags(dz.astype(np.float64))).tocsr()
        A_levels.append(A_next)
        P_levels.append(P)

    n_coarse = A_levels[-1].shape[0]
    if n_coarse > 20 * max_coarse:
        msg = (
            f"AMG coarsening stalled at {n_coarse} dofs; dense coarse solve "
            "would be too large: check the mesh connectivity"
        )
        raise RuntimeError(msg)
    coarse_inv = np.linalg.inv(A_levels[-1].toarray())
    t1 = time.perf_counter()
    if spmv == "windowed":
        amg = _freeze_windowed(
            space, A_levels, P_levels, agg_levels, bs_levels, coarse_inv, omega, nu,
            node_perm, device, dtype, select_passes, tile_rows,
        )
    else:
        amg = _freeze_ell(A_levels, P_levels, coarse_inv, omega, nu, device, dtype)
    amg.build_seconds["hierarchy"] = t1 - t0
    return amg


def _freeze_ell(A_levels, P_levels, coarse_inv, omega, nu, device, dtype) -> AmgPreconditioner:
    """Freeze the SA hierarchy into ELL levels (see build_amg)."""
    t0 = time.perf_counter()

    def ell(A):
        vals, cols = _to_ell(A)
        return torch.as_tensor(vals, dtype=dtype), torch.as_tensor(cols)

    dinv = []
    for A in A_levels[:-1]:
        d = A.diagonal()
        d = np.where(np.abs(d) > 0, d, 1.0)
        dinv.append(torch.as_tensor(1.0 / d, dtype=dtype))
    amg = AmgPreconditioner(
        A_ell=[ell(A) for A in A_levels[:-1]],
        P_ell=[ell(P) for P in P_levels],
        R_ell=[ell(P.T.tocsr()) for P in P_levels],
        dinv=dinv,
        coarse_inv=torch.as_tensor(coarse_inv, dtype=dtype),
        omega=omega,
        nu=nu,
    )
    t1 = time.perf_counter()
    amg.to(device)  # every level in one step
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    amg.build_seconds.update(freeze=t1 - t0, upload=time.perf_counter() - t1)
    return amg


def _freeze_windowed(
    space, A_levels, P_levels, agg_levels, bs_levels, coarse_inv, omega, nu,
    node_perm, device, dtype, select_passes, tile_rows,
) -> WindowedAmgPreconditioner:
    """Freeze the SA hierarchy into windowed BSR plans (see build_amg)."""
    from ..ops.windowed import reverse_cuthill_mckee
    from ..ops.windowed_bsr import _GRAN, _round_up, build_windowed_bsr

    t0 = time.perf_counter()
    n_levels = len(A_levels)
    # per-level node orderings: mesh RCM at the fine level, aggregates by
    # their smallest contained fine node below
    if node_perm is None:
        node_perm = reverse_cuthill_mckee(
            np.asarray(space.cell_dof_nodes), space.n_dof_nodes
        )
    perms = [np.asarray(node_perm, np.int64)]
    for agg in agg_levels:
        n_agg = int(agg.max()) + 1
        key = np.full(n_agg, np.iinfo(np.int64).max)
        np.minimum.at(key, agg, perms[-1])
        order = np.argsort(key, kind="stable")
        nxt = np.empty(n_agg, np.int64)
        nxt[order] = np.arange(n_agg)
        perms.append(nxt)

    T_r = int(tile_rows)
    n_nodes = [A.shape[0] // bs for A, bs in zip(A_levels, bs_levels)]
    # levels are both row AND col spaces of the inter-level operators, so
    # pad to a common multiple of the row tile and the column granule
    NP = [_round_up(n, math.lcm(T_r, _GRAN)) for n in n_nodes]
    # plans are built on the host and moved to the device in one step below
    opts = dict(tile_rows=T_r, device="cpu", dtype=dtype, select_passes=select_passes)

    A_win = [
        build_windowed_bsr(
            A_levels[lv], bs_levels[lv], bs_levels[lv], perms[lv], perms[lv],
            n_pad_rows=NP[lv], n_pad_cols=NP[lv], **opts,
        )
        for lv in range(n_levels - 1)
    ]
    P_win = [
        build_windowed_bsr(
            P_levels[lv], bs_levels[lv], bs_levels[lv + 1], perms[lv], perms[lv + 1],
            n_pad_rows=NP[lv], n_pad_cols=NP[lv + 1], **opts,
        )
        for lv in range(n_levels - 1)
    ]
    R_win = [
        build_windowed_bsr(
            P_levels[lv].T.tocsr(), bs_levels[lv + 1], bs_levels[lv], perms[lv + 1],
            perms[lv], n_pad_rows=NP[lv + 1], n_pad_cols=NP[lv], **opts,
        )
        for lv in range(n_levels - 1)
    ]

    dinv_int = []
    for lv in range(n_levels - 1):
        d = A_levels[lv].diagonal()
        d = np.where(np.abs(d) > 0, d, 1.0)
        di = (1.0 / d).reshape(n_nodes[lv], bs_levels[lv]).T
        full = np.zeros((bs_levels[lv], NP[lv]))
        full[:, : n_nodes[lv]] = di[:, np.argsort(perms[lv])]
        dinv_int.append(torch.as_tensor(full.reshape(-1), dtype=dtype))

    # dense coarsest inverse, COMPACT: comp-major over the coarsest level's
    # node order at the natural coarse size (bsc*nc)^2, not embedded in the
    # tile-padded level space (which would square the padding); _cycle
    # slices and pads the coarse vectors around the dense solve instead
    lc = n_levels - 1
    nc, bsc = n_nodes[lc], bs_levels[lc]
    i_cmp = (perms[lc][np.arange(nc)][None, :] + (np.arange(bsc) * nc)[:, None]).reshape(-1)
    # natural dof order is node-major: dof = node*bsc + comp
    nat = (np.arange(nc)[None, :] * bsc + np.arange(bsc)[:, None]).reshape(-1)
    Ccmp = np.zeros((bsc * nc, bsc * nc))
    Ccmp[np.ix_(i_cmp, i_cmp)] = coarse_inv[np.ix_(nat, nat)]

    amg = WindowedAmgPreconditioner(
        A_win=A_win,
        P_win=P_win,
        R_win=R_win,
        dinv_int=dinv_int,
        coarse_inv=torch.as_tensor(Ccmp, dtype=dtype),
        nc=nc,
        bsc=bsc,
        NPc=NP[lc],
        perm_dev=torch.as_tensor(perms[0], dtype=torch.int64),
        invperm_dev=torch.as_tensor(np.argsort(perms[0]), dtype=torch.int64),
        omega=omega,
        nu=nu,
        n_levels=n_levels,
        vs=bs_levels[0],
        n_nodes0=n_nodes[0],
        NP0=NP[0],
    )
    t1 = time.perf_counter()
    amg.to(device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    amg.build_seconds.update(freeze=t1 - t0, upload=time.perf_counter() - t1)
    return amg
