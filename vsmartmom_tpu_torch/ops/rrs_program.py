"""The phase program of the split RRS kernel K3 (``csrc/fused_rrs.cu``).

Every operator of a (shift, point) pair's ladder and adding is
block-lower-triangular, [[X11, 0], [X21, X22]], and a product's diagonal
blocks depend only on the factors' diagonal blocks:

    (A B)11 = A11 B11,   (A B)22 = A22 B22,   (A B)21 = A21 B11 + A22 B21.

The diagonal blocks are the elastic problem of one grid point (X11 that of
the source point i + shift, X22 that of the target point i), the same for
every shift that uses the point. So K3 runs in two launches over one
program of phases (K1's ladder and adding, ``csrc/fused_band.cu``):

* the diagonal launch, one block per grid point, runs the program as K1
  runs it (N x N products on ``csrc/fp32_tile.cuh``) and saves to a global
  store every diagonal value that a (2,1) product reads (``saves``);
* the pair launch, one block per on-grid pair, runs the same program on the
  (2,1) blocks alone: each product C21 = A21 B11 + A22 B21 is one job of
  depth 2N whose diagonal factors A22 (the target's) and B11 (the
  source's) are staged from the store into a pool of shared-memory slots
  (``stages``), the next phase's while the current one computes.

This module builds that program on the host, once per (nz, schedule,
ns_inter, pool size), and encodes it as an int32 table of ``REC`` ints a
record that both kernels and ``fused_rrs.moment_rrs_split_reference``
read. It also lays out the pairs (``pair_plan``).

Slots are K1's: matrices 0-3 the composite (R-+, R+-, T++, T--; T++ moves),
4-9 the layer's r, t and four temporaries, ``N_MAT + q`` the pool; vectors
0-1 the composite's J+, J-, 2-3 the layer's j+, j- (starred), 4-6
temporaries, 7 the per-row attenuation ek, ``N_VEC + q`` the pool.
"""

from functools import lru_cache
from typing import NamedTuple

import numpy as np

N_MAT, N_VEC = 10, 8
RMP, RPM, TPP0, TMM = 0, 1, 2, 3
VJP, VJM, Vjp, Vjm, VA, VB, VC, VEK = range(N_VEC)
#: Vector pool slots: two vector jobs a phase, double-buffered.
VPOOL = 4

# Epilogues, as csrc/fp32_tile.cuh numbers them.
(E_ST, E_ACC, E_NS, E_ADD, E_SGN, E_EK, E_SEED, E_ACCD, E_ROWD,
 E_SGND) = range(10)

# Record layout (int32 each).
REC = 40
OP_PHASE, OP_ASSEMBLE = 0, 1
F_OP, F_ARG, F_NEXT, F_PREFETCH = 0, 1, 2, 3
F_S0, F_S1, F_S2 = 4, 5, 6          # assemble: r, t, starred; phase: ride slots
F_NM, F_M, F_M2 = 7, 8, 11          # matrix jobs: count, codes, (2,1) codes
F_NV, F_V, F_V2 = 14, 15, 17        # vector jobs: count, codes, (2,1) codes
F_NSAVE, F_SAVE = 19, 20            # diagonal launch: slot -> store entry
F_NSTAGE, F_STAGE = 28, 29          # pair launch: store entry -> pool slot
MAX_SAVE = MAX_STAGE = 8
# Rides (elementwise passes in front of a phase's jobs, under its barrier):
RIDE_EK = 1      # ek <- ek^2 (every doubling step after the first)
RIDE_VA = 2      # va <- jm ek (slots F_S1, F_S2)
RIDE_FLIP = 4    # t <- D t D (slot F_S0): t-- for the adding
# Store roles: a (2,1) product reads A22 from the target's store, B11 from
# the source's.
ROLE_A, ROLE_B = 0, 1


def job(A, B, C, epi=E_ST, E=0):
    """A job's slots and epilogue in one int (``fp32_tile::job``)."""
    return A | (B << 5) | (C << 10) | (E << 15) | (epi << 20)


class Job(NamedTuple):
    """C = epi(A @ B) (matrix job; for a vector job A is a matrix slot and
    B, C, E vector slots)."""
    A: int
    B: int
    C: int
    epi: int = E_ST
    E: int = 0


class Phase(NamedTuple):
    mats: tuple
    vecs: tuple = ()
    rides: tuple = ()      # ("ek",), ("va", va, jm), ("flip", t)


class Assemble(NamedTuple):
    z: int
    r: int
    t: int
    starred: bool


def _ns(prog, S, m, c, nm, iters):
    """Newton-Schulz phases m <- m (2I - m + S m) from the seed in m."""
    for _ in range(iters):
        prog.append(Phase((Job(S, m, c, E_NS, m),)))
        prog.append(Phase((Job(m, c, nm),)))
        m, nm = nm, m
    return m, c, nm


def program(nz, sched, ns_inter):
    """K1's layer loop as phases: per layer the assembly, the doubling
    ladder (its last step unstars r and jm in its epilogue) and the adding
    onto the composite. Returns (phases, the slots of R-+, R+-, T++, T--,
    J+, J- at the end)."""
    prog = []
    r, t, T = 4, 5, [6, 7, 8, 9]
    tpp = TPP0
    for z in range(nz):
        prog.append(Assemble(z, r, t, len(sched) > 0))
        for step, k in enumerate(sched):
            S, m, c, nm = T
            rides = ((("ek",),) if step > 0 else ()) + (("va", VA, Vjm),)
            prog.append(Phase((Job(r, r, S, E_SEED, m),), (), rides))
            m, c, nm = _ns(prog, S, m, c, nm, k)
            acc = E_ACCD if step == len(sched) - 1 else E_ACC
            prog.append(Phase((Job(t, m, S), Job(r, t, c)),
                              (Job(r, Vjp, VB, E_ADD, VA),
                               Job(r, VA, VC, E_ADD, Vjp))))
            prog.append(Phase((Job(S, t, nm), Job(S, c, r, acc)),
                              (Job(S, VB, Vjm, acc), Job(S, VC, Vjp, E_EK))))
            T = [t, m, S, c]
            t = nm
        S, m, c, nm = T
        prog.append(Phase((Job(r, RPM, S, E_SEED, m),), (), (("flip", t),)))
        m, c, nm = _ns(prog, S, m, c, nm, ns_inter)
        prog.append(Phase((Job(TMM, m, S), Job(r, tpp, c), Job(m, r, nm)),
                          (Job(r, VJP, VA, E_ADD, Vjm),)))
        prog.append(Phase((Job(S, t, TMM), Job(S, c, RMP, E_ACC),
                           Job(RPM, nm, m, E_ROWD)),
                          (Job(S, VA, VJM, E_ACC),
                           Job(RPM, Vjm, VB, E_ADD, VJP))))
        prog.append(Phase((Job(RPM, t, nm), Job(t, m, c, E_SGND, t))))
        prog.append(Phase((Job(c, tpp, S), Job(c, nm, RPM, E_SGN, r)),
                          (Job(c, VB, VJP, E_ADD, Vjp),)))
        T = [tpp, m, c, nm]
        tpp = S
    return prog, (RMP, RPM, tpp, TMM, VJP, VJM)


def _operands(ph, ver):
    """A phase's staged operands: matrix keys (("m", slot, version), role)
    and vector keys, each list in first-use order without repeats."""
    mats, vecs = [], []
    for j in ph.mats:
        for key in ((("m", j.A, ver["m", j.A]), ROLE_A),
                    (("m", j.B, ver["m", j.B]), ROLE_B)):
            if key not in mats:
                mats.append(key)
    for j in ph.vecs:
        key = (("m", j.A, ver["m", j.A]), ROLE_A)
        if key not in mats:
            mats.append(key)
        key = (("v", j.B, ver["v", j.B]), ROLE_B)
        if key not in vecs:
            vecs.append(key)
    return mats, vecs


def _written(op):
    """The (kind, slot)s an op writes."""
    if isinstance(op, Assemble):
        return [("m", op.r), ("m", op.t), ("v", Vjp), ("v", Vjm),
                ("v", VEK)]
    out = [("m", j.C) for j in op.mats] + \
        [("m", j.E) for j in op.mats if j.epi == E_SEED] + \
        [("v", j.C) for j in op.vecs]
    for ride in op.rides:
        if ride[0] == "ek":
            out.append(("v", VEK))
        elif ride[0] == "va":
            out.append(("v", ride[1]))
        else:
            out.append(("m", ride[1]))
    return out


def _split(ph, ver, pool):
    """ph as consecutive phases whose staged matrices fit the pool (jobs of
    one phase read no output of the phase, so any split is exact); the
    rides go with the first."""
    mats, vecs = _operands(ph, ver)
    if len(mats) <= pool and len(vecs) <= VPOOL // 2:
        return [ph]
    out, cur = [], Phase((), (), ph.rides)
    for kind, j in [("mats", j) for j in ph.mats] + \
            [("vecs", j) for j in ph.vecs]:
        grown = cur._replace(**{kind: getattr(cur, kind) + (j,)})
        m, v = _operands(grown, ver)
        if (cur.mats or cur.vecs) and (len(m) > pool or len(v) > VPOOL // 2):
            out.append(cur)
            grown = Phase(*(((j,), ()) if kind == "mats" else ((), (j,))))
        cur = grown
    return out + [cur]


class Plan(NamedTuple):
    table: np.ndarray       # (n_records, REC) int32
    n_mat_entries: int      # store matrices a point
    n_vec_entries: int      # store vectors a point
    layer_entries: tuple    # first matrix entry of each layer, and the end
    pool: int               # matrix pool slots (pair launch)
    outs: tuple             # final slots of R-+, R+-, T++, T--, J+, J-
    n_phases: int
    n_stage_mats: int       # staged matrix loads a pair makes (all layers)
    n_prefetched: int       # phase records whose loads overlap the last


def _pool_need(prog):
    """Pool slots for every phase's loads to overlap the previous phase's
    jobs without splitting any phase."""
    ver, need, prev = _Ver(), 0, []
    for op in prog:
        if isinstance(op, Phase):
            mats, _ = _operands(op, ver)
            need = max(need, len(set(mats) | set(prev)))
            prev = mats
        for w in _written(op):
            ver[w] += 1
    return need


class _Ver(dict):
    def __missing__(self, key):
        return 0


@lru_cache(maxsize=64)
def build_plan(nz, sched, ns_inter, pool=None):
    """The program's table for a matrix pool of ``pool`` slots (None: as
    many as every phase needs for its loads to overlap the previous phase's
    jobs). Phases that stage more than the pool holds are split; a phase
    whose new loads do not fit beside the previous phase's operands is
    marked not prefetched (loaded after the previous phase, then waited
    for)."""
    sched = tuple(int(k) for k in sched)
    prog, outs = program(nz, sched, ns_inter)
    if pool is None:
        pool = _pool_need(prog)
    if pool < 2 or N_MAT + pool > 32:
        raise ValueError(f"pool of {pool} matrix slots: the plan needs 2 to "
                         f"{32 - N_MAT}")
    ver = _Ver()
    ops = []                                  # (op, mats, vecs)
    for op in prog:
        if isinstance(op, Phase):
            for sub in _split(op, ver, pool):
                ops.append((sub, *_operands(sub, ver)))
        else:
            ops.append((op, None, None))
        for w in _written(op):
            ver[w] += 1
    entry = {"m": {}, "v": {}}
    layer_entries = []
    rows = []
    prev_m, prev_v = {}, {}
    n_stage = n_pre = 0
    for op, mats, vecs in ops:
        rec = np.zeros(REC, np.int64)
        if isinstance(op, Assemble):
            layer_entries.append(len(entry["m"]))
            rec[[F_OP, F_ARG, F_S0, F_S1, F_S2]] = (OP_ASSEMBLE, op.z, op.r,
                                                   op.t, int(op.starred))
            rows.append(rec)
            continue
        saves = []
        for key, _ in mats + vecs:
            kind = key[0]
            if key not in entry[kind]:
                entry[kind][key] = len(entry[kind])
                saves.append((kind == "v", key[1], entry[kind][key]))
        # Pool slots: keep an operand the previous phase staged; put new ones
        # in slots the previous phase does not read (prefetch) or, where
        # they do not fit, anywhere (loaded after the previous phase).
        bufs = {}
        prefetch = True
        for keys, prev, size, base in ((mats, prev_m, pool, N_MAT),
                                       (vecs, prev_v, VPOOL, N_VEC)):
            keep = {k: prev[k] for k in keys if k in prev}
            new = [k for k in keys if k not in prev]
            free = [b for b in range(base, base + size)
                    if b not in prev.values()]
            if len(new) > len(free):
                prefetch = False
                free = [b for b in range(base, base + size)
                        if b not in keep.values()]
            bufs.update(keep)
            bufs.update(zip(new, free))
        stages = [(k[0][0] == "v", k[1], bufs[k], entry[k[0][0]][k[0]])
                  for k in mats + vecs if k not in prev_m and k not in prev_v]
        n_stage += sum(1 for s in stages if not s[0])
        n_pre += prefetch
        prev_m = {k: bufs[k] for k in mats}
        prev_v = {k: bufs[k] for k in vecs}
        flags = 0
        for ride in op.rides:
            if ride[0] == "ek":
                flags |= RIDE_EK
            elif ride[0] == "va":
                flags |= RIDE_VA
                rec[F_S1], rec[F_S2] = ride[1], ride[2]
            else:
                flags |= RIDE_FLIP
                rec[F_S0] = ride[1]
        rec[[F_OP, F_ARG, F_PREFETCH]] = (OP_PHASE, flags, int(prefetch))
        rec[F_NM] = len(op.mats)
        for q, j in enumerate(op.mats):
            rec[F_M + q] = job(j.A, j.B, j.C, j.epi, j.E)
            a22 = bufs[next(k for k in mats if k[1] == ROLE_A
                            and k[0][1] == j.A)]
            b11 = bufs[next(k for k in mats if k[1] == ROLE_B
                            and k[0][1] == j.B)]
            rec[F_M2 + q] = a22 | (b11 << 5)
        rec[F_NV] = len(op.vecs)
        for q, j in enumerate(op.vecs):
            rec[F_V + q] = job(j.A, j.B, j.C, j.epi, j.E)
            a22 = bufs[next(k for k in mats if k[1] == ROLE_A
                            and k[0][1] == j.A)]
            x1 = bufs[next(k for k in vecs if k[0][1] == j.B)]
            rec[F_V2 + q] = a22 | (x1 << 5)
        if len(saves) > MAX_SAVE or len(stages) > MAX_STAGE:
            raise ValueError(f"a phase saves {len(saves)} and stages "
                             f"{len(stages)} values; a record holds "
                             f"{MAX_SAVE} and {MAX_STAGE}")
        rec[F_NSAVE] = len(saves)
        for q, (is_vec, slot, e) in enumerate(saves):
            rec[F_SAVE + q] = (int(is_vec) << 30) | (slot << 20) | e
        rec[F_NSTAGE] = len(stages)
        for q, (is_vec, role, slot, e) in enumerate(stages):
            rec[F_STAGE + q] = ((int(is_vec) << 30) | (role << 29)
                                | (slot << 20) | e)
        rows.append(rec)
    table = np.stack(rows)
    phase_rows = [i for i, r in enumerate(table) if r[F_OP] == OP_PHASE]
    table[:, F_NEXT] = -1
    for a, b in zip(phase_rows, phase_rows[1:]):
        table[a, F_NEXT] = b
    if max(len(entry["m"]), len(entry["v"])) >= 1 << 20:
        raise ValueError("the program's store needs more than 2^20 entries")
    layer_entries.append(len(entry["m"]))
    return Plan(table.astype(np.int32), len(entry["m"]), len(entry["v"]),
                tuple(layer_entries), pool, outs, len(phase_rows), n_stage,
                n_pre)


def decode_stage(code):
    """(is_vec, role, slot, entry) of a stage code (a save: role 0)."""
    return ((code >> 30) & 1, (code >> 29) & 1, (code >> 20) & 31,
            code & 0xFFFFF)


def pair_plan(shifts, s):
    """The pair launch's grid: every on-grid (shift r, point i) pair
    (0 <= i + shift < s), target-major with the shifts inner, so the blocks
    in flight share their target points and a window of source points.
    Returns an int32 (P_on, 3) array of (pair index r s + i, target i,
    source i + shift); off-grid pairs are not launched (their (2,1) blocks
    are exactly zero)."""
    rows = [(r * s + i, i, i + sh) for i in range(s)
            for r, sh in enumerate(shifts) if 0 <= i + sh < s]
    return np.asarray(rows, np.int32).reshape(-1, 3)
