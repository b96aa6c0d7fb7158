"""Blocked (recursive) Cholesky + triangular solve.

A stock Cholesky whose inner loop factorizes narrow panels is latency
bound at large n.  Because shapes are static under ``jit`` we can instead
recurse at *trace time*:

    [[A11, .  ],      L11 = chol(A11)
     [A21, A22]]  ->  L21 = A21 L11^-T            (triangular solve)
                      L22 = chol(A22 - L21 L21^T) (trailing GEMM update)

Every level splits the matrix in half, so ~2/3 of the flops land in the
trailing-update GEMMs and the sequential part shrinks
geometrically.  Exact flop count n^3/3 — no masking waste.  This is the
numerics replacement for the reference's LAPACK ``dpotrf`` path
(reference include/LAPACKUtils.h:59-73).

``solve_triangular_blocked`` recurses the same way so the solve's matmul
fraction also runs as GEMMs.  Whether this recursion beats one vendor
``potrf`` call on a given card is a measurement (PERF.md), not a premise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.config import matmul_precision


def _default_leaf() -> int:
    """Precision-dependent recursion leaf: cheap GEMMs at the 'default'
    tier favour small leaves, f32-grade GEMMs bigger ones.  Not yet tuned
    on the GPU; GPR_CHOL_LEAF overrides for on-chip A/B."""
    import os

    env = os.environ.get("GPR_CHOL_LEAF")
    if env:
        return int(env)
    return 256 if matmul_precision() == "default" else 1024


def _round_split(n: int, align: int = 128) -> int:
    """Split point: half of n rounded up to the alignment (GEMM tiles)."""
    half = (n + 1) // 2
    return min(((half + align - 1) // align) * align, n - 1) if n > align else n // 2


def solve_triangular_blocked(
    L: jax.Array, B: jax.Array, *, lower: bool = True, leaf: int = 0
) -> jax.Array:
    """X with L X = B (L lower-triangular), recursively blocked.

    [[L11,  0 ], [X1]   [B1]      X1 = L11^-1 B1
     [L21, L22]] [X2] = [B2]  ->  X2 = L22^-1 (B2 - L21 X1)
    """
    if leaf <= 0:
        leaf = _default_leaf()
    if not lower:
        # U X = B with U upper: solve via the lower-triangular routine on
        # the flipped problem (reverse both axes)
        Lf = L[::-1, ::-1]
        Bf = B[::-1]
        Xf = solve_triangular_blocked(Lf, Bf, lower=True, leaf=leaf)
        return Xf[::-1]

    n = L.shape[0]
    if n <= leaf:
        return jax.scipy.linalg.solve_triangular(L, B, lower=True)
    m = _round_split(n)
    L11, L21, L22 = L[:m, :m], L[m:, :m], L[m:, m:]
    B1, B2 = B[:m], B[m:]
    X1 = solve_triangular_blocked(L11, B1, lower=True, leaf=leaf)
    rhs = B2 - jnp.matmul(
        L21, X1, preferred_element_type=B.dtype,
        precision=matmul_precision(),
    )
    X2 = solve_triangular_blocked(L22, rhs, lower=True, leaf=leaf)
    return jnp.concatenate([X1, X2], axis=0)


_NT = (((1,), (1,)), ((), ()))  # X @ Y^T without a physical transpose


def _solve_rt(L, B, leaf):
    """X with ``X @ L^T = B`` (B: (r, n)) — the factorization's column
    solve ``L21 = A21 @ L11^{-T}`` computed right-side so NO physical
    transpose is materialized anywhere (the ``solve(L, A21^T)^T`` form
    pays two transposes per level)."""
    n = L.shape[0]
    if n <= leaf:
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=False, lower=True, transpose_a=True
        )
    m = _round_split(n)
    X1 = _solve_rt(L[:m, :m], B[:, :m], leaf)
    rhs = B[:, m:] - jax.lax.dot_general(
        X1, L[m:, :m], _NT, preferred_element_type=B.dtype,
        precision=matmul_precision(),
    )
    X2 = _solve_rt(L[m:, m:], rhs, leaf)
    return jnp.concatenate([X1, X2], axis=1)


def _walk_blocks(b, i0, j0, out):
    """Flatten a block tree into (row, col, block) triples (lower only)."""
    if not isinstance(b, tuple):
        out.append((i0, j0, b))
        return b.shape[0]
    b11, L21, b22 = b
    m = _walk_blocks(b11, i0, j0, out)
    out.append((i0 + m, j0, L21))
    s = _walk_blocks(b22, i0 + m, j0 + m, out)
    return m + s


def assemble_blocks_dus(b) -> jax.Array:
    """Assemble a block tree by writing each lower block into one zero
    buffer with static-offset in-place DUS: each block is written exactly
    once into a memset buffer, where the concat form may materialize pred
    masks and full-width selects."""
    if not isinstance(b, tuple):
        return b
    blocks: list = []
    n = _walk_blocks(b, 0, 0, blocks)
    out = jnp.zeros((n, n), blocks[0][2].dtype)
    for i0, j0, blk in blocks:
        out = jax.lax.dynamic_update_slice(out, blk, (i0, j0))
    return out


def assemble_blocks(b) -> jax.Array:
    """Assemble a block tree from :func:`cholesky_blocked_blocks` into the
    full lower-triangular factor.  Leaf = the factor array itself; node =
    ``(blocks11, L21, blocks22)``.  GPR_CHOL_ASSEMBLE picks the form
    ('concat' default, 'dus') for on-chip A/B."""
    import os

    if os.environ.get("GPR_CHOL_ASSEMBLE", "concat") == "dus":
        return assemble_blocks_dus(b)
    return assemble_blocks_concat(b)


def assemble_blocks_concat(b) -> jax.Array:
    """The original concat-tree assembly (kept for A/B; see
    :func:`assemble_blocks`)."""
    if not isinstance(b, tuple):
        return b
    b11, L21, b22 = b
    L11, L22 = assemble_blocks_concat(b11), assemble_blocks_concat(b22)
    m = L11.shape[0]
    n = m + L22.shape[0]
    top = jnp.concatenate([L11, jnp.zeros((m, n - m), L11.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def last_leaf(b) -> jax.Array:
    """The bottom-right leaf factor of a block tree — a failed pivot
    anywhere propagates NaN into this block's last diagonal entry."""
    while isinstance(b, tuple):
        b = b[2]
    return b


def _chol_rec(A, leaf, gemm_dtype, rt):
    n = A.shape[0]
    if n <= leaf:
        return jax.lax.linalg.cholesky(A, symmetrize_input=False)
    m = _round_split(n)
    A11 = A[:m, :m]
    A21 = A[m:, :m]
    A22 = A[m:, m:]
    b11 = _chol_rec(A11, leaf, gemm_dtype, rt)
    L11 = assemble_blocks(b11)
    if rt:
        # right-side solve: no physical transpose of A21 or the result
        L21 = _solve_rt(L11, A21, leaf)
    elif _flat_solve():
        # ONE XLA triangular-solve call per level (its internal blocking)
        # instead of the trace-time recursion
        L21 = jax.lax.linalg.triangular_solve(
            L11, A21.T, left_side=True, lower=True
        ).T
    else:
        # L21 = A21 L11^-T  ==  (L11^-1 A21^T)^T
        L21 = solve_triangular_blocked(L11, A21.T, lower=True, leaf=leaf).T
    if gemm_dtype is not None:
        upd = jnp.matmul(
            L21.astype(gemm_dtype),
            L21.T.astype(gemm_dtype),
            preferred_element_type=A.dtype,
        ).astype(A.dtype)
    else:
        upd = jnp.matmul(
            L21, L21.T, preferred_element_type=A.dtype,
            precision=matmul_precision(),
        )
    b22 = _chol_rec(A22 - upd, leaf, gemm_dtype, rt)
    return (b11, L21, b22)


def cholesky_blocked_blocks(
    A: jax.Array, *, leaf: int = 0, gemm_dtype=None,
    right_solve: bool | None = None,
):
    """Blocked Cholesky returning the UNASSEMBLED block tree (see
    :func:`assemble_blocks`).  This is what retry loops should carry:
    a ``lax.while_loop`` carry of the assembled factor forces the whole
    concat tree to materialize every iteration; carrying the blocks and
    assembling once after the loop keeps the zero-iteration success path
    copy-free."""
    if leaf <= 0:
        leaf = _default_leaf()
    if right_solve is None:
        right_solve = _right_solve_default()
    return _chol_rec(A, leaf, gemm_dtype, right_solve)


# Right-side (transpose-free) panel solves: the left-side form
# solve(L11, A21.T).T pays a physical layout copy of the A21 slice per
# level; the right-side lax triangular_solve consumes A21 in its native
# layout.  GPR_CHOL_RIGHT_SOLVE=1/0 overrides the default for A/B.
_RIGHT_SOLVE_DEFAULT = False


def _right_solve_default() -> bool:
    import os

    env = os.environ.get("GPR_CHOL_RIGHT_SOLVE")
    return _RIGHT_SOLVE_DEFAULT if env is None else env not in ("0", "")


def _flat_solve() -> bool:
    """GPR_CHOL_FLAT_SOLVE=1: panel solves as single XLA triangular-solve
    calls (XLA's internal blocking) instead of the recursion."""
    import os

    return os.environ.get("GPR_CHOL_FLAT_SOLVE", "0") not in ("0", "")


def cholesky_blocked(
    A: jax.Array, *, leaf: int = 0, gemm_dtype=None,
    right_solve: bool | None = None,
) -> jax.Array:
    """Lower Cholesky factor of SPD ``A`` by trace-time recursion.

    Like LAPACK ``potrf('L')`` (the reference's path, include/
    LAPACKUtils.h:59-73) this reads ONLY the lower triangle of ``A``: the
    leaves factor with ``symmetrize_input=False`` and every recursion
    read (A11 lower, the dense A21 block, A22 lower) lies on or below the
    diagonal.

    ``gemm_dtype=jnp.bfloat16`` routes the trailing-update GEMM operands
    through bf16 (f32 accumulation) at ~3-decimal-digit operand rounding.
    A throughput option; leave None for parity work."""
    return assemble_blocks(
        cholesky_blocked_blocks(
            A, leaf=leaf, gemm_dtype=gemm_dtype, right_solve=right_solve
        )
    )


def _solve_r(L, B, leaf):
    """X with ``X @ L = B`` (B: (r, n), L lower) — the backward-solve
    sibling of :func:`_solve_rt`: both GEMMs stream untransposed blocks."""
    n = L.shape[0]
    if n <= leaf:
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=False, lower=True, transpose_a=False
        )
    m = _round_split(n)
    X2 = _solve_r(L[m:, m:], B[:, m:], leaf)
    rhs = B[:, :m] - jax.lax.dot_general(
        X2, L[m:, :m],
        (((1,), (0,)), ((), ())), preferred_element_type=B.dtype,
        precision=matmul_precision(),
    )
    X1 = _solve_r(L[:m, :m], rhs, leaf)
    return jnp.concatenate([X1, X2], axis=1)


def cho_solve_blocked(L: jax.Array, B: jax.Array, *, leaf: int = 0) -> jax.Array:
    """Solve A X = B given A = L L^T.

    Both passes run RIGHT-SIDE on the transposed rhs, so the only physical
    transposes are of the skinny (n, q) rhs — the previous formulation
    materialized a full (n, n) ``L.T`` plus three reversal copies (a ~1 GB
    HBM copy at n=16k f32) for the backward solve."""
    if leaf <= 0:
        leaf = _default_leaf()
    if B.ndim == 1:
        return cho_solve_blocked(L, B[:, None], leaf=leaf)[:, 0]
    Bt = B.T  # (q, n): the cheap transpose
    Yt = _solve_rt(L, Bt, leaf)  # Y^T = B^T L^{-T}
    Xt = _solve_r(L, Yt, leaf)            # X^T = Y^T L^{-1}
    return Xt.T


def cholesky_rightlooking(
    A: jax.Array, *, panel: int = 512, leaf: int = 256
) -> jax.Array:
    """Right-looking panel Cholesky with a SHRINKING carried submatrix.

    Alternative schedule kept for study: a python loop over column panels
    carrying only the trailing Schur complement (6 ops per panel, maximal
    GEMMs).  The strictly sequential panel chain gives XLA no independent
    subtree work to overlap, and the per-panel trailing-slice copies add
    ~n^3/(3 panel) bytes of traffic; the recursive variant is the
    dispatch default."""
    n = A.shape[0]
    if n <= panel:
        return cholesky_blocked(A, leaf=leaf)
    pad = (-n) % panel
    if pad:
        # pad with an identity block (keeps SPD); crop at the end
        A = jnp.concatenate(
            [
                jnp.concatenate([A, jnp.zeros((n, pad), A.dtype)], axis=1),
                jnp.concatenate(
                    [jnp.zeros((pad, n), A.dtype), jnp.eye(pad, dtype=A.dtype)],
                    axis=1,
                ),
            ],
            axis=0,
        )
    np_ = A.shape[0]
    nb = np_ // panel

    S = A
    blocks = []  # per panel k: (Lkk, Pk) with Pk possibly empty
    for k in range(nb):
        Akk = S[:panel, :panel]
        Lkk = cholesky_blocked(Akk, leaf=leaf)
        if S.shape[0] > panel:
            below = S[panel:, :panel]
            Pk = solve_triangular_blocked(Lkk, below.T, leaf=leaf).T
            S = S[panel:, panel:] - jnp.matmul(
                Pk, Pk.T, preferred_element_type=A.dtype,
                precision=matmul_precision(),
            )
            S = 0.5 * (S + S.T)
        else:
            Pk = jnp.zeros((0, panel), A.dtype)
        blocks.append((Lkk, Pk))

    cols = []
    for k, (Lkk, Pk) in enumerate(blocks):
        col = jnp.concatenate(
            [jnp.zeros((k * panel, panel), A.dtype), Lkk, Pk], axis=0
        )
        cols.append(col)
    L = jnp.concatenate(cols, axis=1)
    return L[:n, :n]


# ---------------------------------------------------------------------------
# v2: buffer-threaded recursion (no per-level concat assembly)
# ---------------------------------------------------------------------------

def _solve_lower_into(L, B_cur, out, i0, leaf):
    """Recursive lower-triangular solve writing X into ``out`` at static
    offsets — the concatenation-free variant (each level's [X1; X2] concat
    in the original costs a full copy of the level's result)."""
    s = B_cur.shape[0]
    if s <= leaf:
        x = jax.scipy.linalg.solve_triangular(
            L[i0 : i0 + s, i0 : i0 + s], B_cur, lower=True
        )
        return out.at[i0 : i0 + s].set(x)
    m = _round_split(s)
    out = _solve_lower_into(L, B_cur[:m], out, i0, leaf)
    X1 = out[i0 : i0 + m]
    rhs = B_cur[m:] - jnp.matmul(
        L[i0 + m : i0 + s, i0 : i0 + m], X1,
        preferred_element_type=B_cur.dtype, precision=matmul_precision(),
    )
    return _solve_lower_into(L, rhs, out, i0 + m, leaf)


def solve_triangular_blocked_v2(
    L: jax.Array, B: jax.Array, *, lower: bool = True, leaf: int = 256
) -> jax.Array:
    """Concat-free blocked triangular solve (see :func:`_solve_lower_into`)."""
    if not lower:
        Xf = solve_triangular_blocked_v2(
            L[::-1, ::-1], B[::-1], lower=True, leaf=leaf
        )
        return Xf[::-1]
    out = jnp.zeros_like(B)
    return _solve_lower_into(L, B, out, 0, leaf)


def _chol_into(A_cur, out, i0, leaf, gemm_dtype):
    """Factor the Schur block ``A_cur`` (global offset i0) into ``out``."""
    s = A_cur.shape[0]
    if s <= leaf:
        # symmetrize_input=False honors the potrf('L') contract: the strict
        # upper of a lower-contract input (a Schur-complement update) is
        # undefined, and jnp.linalg.cholesky would average it in
        return out.at[i0 : i0 + s, i0 : i0 + s].set(
            jax.lax.linalg.cholesky(A_cur, symmetrize_input=False)
        )
    m = _round_split(s)
    out = _chol_into(A_cur[:m, :m], out, i0, leaf, gemm_dtype)
    L11 = out[i0 : i0 + m, i0 : i0 + m]
    L21 = solve_triangular_blocked_v2(L11, A_cur[m:, :m].T, leaf=leaf).T
    out = out.at[i0 + m : i0 + s, i0 : i0 + m].set(L21)
    if gemm_dtype is not None:
        upd = jnp.matmul(
            L21.astype(gemm_dtype), L21.T.astype(gemm_dtype),
            preferred_element_type=A_cur.dtype,
        ).astype(A_cur.dtype)
    else:
        upd = jnp.matmul(
            L21, L21.T, preferred_element_type=A_cur.dtype,
            precision=matmul_precision(),
        )
    # no symmetrization: every consumer (leaf cholesky, A21 slices) reads
    # only the lower triangle
    return _chol_into(A_cur[m:, m:] - upd, out, i0 + m, leaf, gemm_dtype)


def cholesky_blocked_v2(
    A: jax.Array, *, leaf: int = 256, gemm_dtype=None
) -> jax.Array:
    """Buffer-threaded recursive Cholesky: identical math to
    :func:`cholesky_blocked` but L is written into ONE preallocated buffer
    with static-offset ``.at.set`` instead of concatenating at every
    recursion level.  Kept for study; v1 remains the dispatch default."""
    n = A.shape[0]
    if n <= leaf:
        return jnp.linalg.cholesky(A)
    out = jnp.zeros_like(A)
    return _chol_into(A, out, 0, leaf, gemm_dtype)
