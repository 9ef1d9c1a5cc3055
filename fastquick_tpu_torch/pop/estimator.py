"""Contamination + ancestry estimation (VerifyBamID2 equivalent).

Equivalent of ContaminationEstimator (VerifyBamID/ContaminationEstimator.*):
the PCA-space allele-frequency model AF = (UD . PC + mu)/2
(ContaminationEstimator.h:236-250), genotype-conditional base likelihoods
(getConditionalBaseLK :142-196), the 3x3 genotype mixture with
contamination alpha (ComputeMixLLKs :206-281), and the Nelder-Mead
optimization ladder (Homo/Heter x fixed-PC/fixed-alpha,
ContaminationEstimator.cpp:29-282) on an exact AmoebaMinimizer replica
(MathGenMin.cpp:313-455).

TPU-first design of the hot loop: per-base likelihoods depend only on
(base class, base quality), so each marker's pileup collapses to a count
vector over 3x94 (class, qual) bins and ComputeMixLLKs becomes one
(markers x bins) @ (bins x 9) matmul + per-marker mixture reduction --
MXU-shaped, identical math (the reference's own OpenMP reduction already
makes its sum order nondeterministic).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..utils.logging import notice, warning
from .pileup import PileupData

N_QBINS = 94  # qual-33 in [0, 93]
N_CLASS = 3  # 0: ref ('.'/','), 1: alt, 2: other
MIN_AF, MAX_AF = 0.00005, 0.99995

# getConditionalBaseLK tables [genotype][class] (h:142-196)
LK_NOERR = np.array([
    [1.0, 0.0, 0.0],
    [0.5, 0.5, 0.0],
    [0.0, 1.0, 0.0],
])
LK_ERR = np.array([
    [0.0, 1.0 / 3.0, 2.0 / 3.0],
    [1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0],
    [1.0 / 3.0, 0.0, 2.0 / 3.0],
])

ZEPS = 1e-10
FPMAX = float(np.finfo(np.float64).max)


def logit(x: float) -> float:
    return math.log(x / (1.0 - x))


def inv_logit(x: float) -> float:
    e = math.exp(x)
    return e / (1.0 + e)


class AmoebaMinimizer:
    """Exact replica of statgen's AmoebaMinimizer (MathGenMin.cpp:313-455)."""

    def __init__(self, func):
        self.func = func
        self.cycle_max = 50000
        self.fmin = FPMAX
        self.point = None

    def reset(self, ndim: int, scale: float = 1.0):
        self.ndim = ndim
        self.directions = np.eye(ndim) * scale
        self.fmin = FPMAX

    def _f(self, v: np.ndarray) -> float:
        y = self.func(v)
        if y < self.fmin:
            self.fmin = y
        return y

    def minimize(self, ftol: float) -> float:
        ndim = self.ndim
        if ndim == 0:
            return self._f(self.point)
        nvertex = ndim + 1
        simplex = np.zeros((nvertex, ndim))
        y = np.zeros(nvertex)
        for i in range(ndim):
            simplex[i] = self.point + self.directions[i]
            y[i] = self._f(simplex[i])
        simplex[nvertex - 1] = self.point
        y[nvertex - 1] = self._f(simplex[nvertex - 1])
        cycle_count = nvertex
        psum = simplex.sum(axis=0)

        def amoeba(ihi: int, factor: float) -> float:
            nonlocal psum
            fac = (1.0 - factor) / ndim
            ptry = fac * psum + (factor - fac) * simplex[ihi]
            ytry = self._f(ptry)
            if ytry < y[ihi]:
                y[ihi] = ytry
                psum -= simplex[ihi]
                simplex[ihi] = ptry
                psum += ptry
            return ytry

        while True:
            if y[0] > y[1]:
                ihi, ilo, inhi = 0, 1, 1
            else:
                ihi, ilo, inhi = 1, 0, 0
            for i in range(2, nvertex):
                if y[i] <= y[ilo]:
                    ilo = i
                elif y[i] > y[ihi]:
                    inhi = ihi
                    ihi = i
                elif y[i] > y[inhi]:
                    inhi = i
            rtol = 2 * abs(y[ihi] - y[ilo]) / (abs(y[ihi]) + abs(y[ilo]) + ZEPS)
            if rtol < ftol:
                self.point = simplex[ilo].copy()
                self.fmin = y[ilo]
                return self.fmin
            if cycle_count > self.cycle_max:
                warning("Amoeba.Minimize - Couldn't converge in %d cycles",
                        self.cycle_max)
                return FPMAX
            cycle_count += 2
            ytry = amoeba(ihi, -1.0)
            if ytry <= y[ilo]:
                amoeba(ihi, 2.0)
            elif ytry >= y[inhi]:
                ysave = y[ihi]
                ytry = amoeba(ihi, 0.5)
                if ytry >= ysave:
                    for i in range(nvertex):
                        if i != ilo:
                            simplex[i] = (simplex[i] + simplex[ilo]) * 0.5
                            y[i] = self._f(simplex[i])
                    cycle_count += ndim
                    psum = simplex.sum(axis=0)
            else:
                cycle_count -= 1


@dataclass
class ContaminationEstimator:
    num_pc: int = 4
    num_thread: int = 4
    epsilon: float = 1e-8
    is_pc_fixed: bool = False
    is_alpha_fixed: bool = False
    is_af_known: bool = False
    is_heter: bool = True
    is_sanity_check_disabled: bool = False
    verbose: bool = False
    alpha: float = 0.5
    # opt-in jit/TPU likelihood (pop/device_llk.py); numpy is the
    # bit-parity default.  device_mesh shards the marker axis (+psum).
    use_device: bool = False
    device_mesh: object = None
    device_axis: object = "dp"

    UD: np.ndarray | None = None  # (markers, num_pc)
    means: np.ndarray | None = None  # (markers,)
    bed_vec: list[tuple[str, int, int]] = field(default_factory=list)
    pos_vec: list[tuple[str, int]] = field(default_factory=list)
    choose_bed: dict[str, dict[int, tuple[str, str]]] = field(default_factory=dict)
    known_af: dict[str, dict[int, float]] = field(default_factory=dict)
    PC: list[list[float]] = field(default_factory=lambda: [[], []])
    viewer: PileupData | None = None

    # fn state
    llk0: float = 0.0
    llk1: float = 0.0
    global_pc: list[float] = field(default_factory=list)
    global_pc2: list[float] = field(default_factory=list)
    global_alpha: float = 0.0

    def __post_init__(self):
        self.PC = [[0.0] * self.num_pc, [0.0] * self.num_pc]

    # ---- input readers ----

    def read_choose_bed(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 5:
                    continue
                chrom, _beg, pos_s, ref, alt = parts[:5]
                pos = int(pos_s)
                self.bed_vec.append((chrom, pos - 1, pos))
                self.pos_vec.append((chrom, pos))
                self.choose_bed.setdefault(chrom, {})[pos] = (ref, alt)

    def read_matrix_ud(self, path: str) -> None:
        """ReadMatrixUD with C stringstream semantics: short lines leave
        the remaining components at the PREVIOUS row's values
        (tmpUD persists across lines, ContaminationEstimator.cpp:298)."""
        rows = []
        tmp = [0.0] * self.num_pc
        with open(path) as fh:
            for line in fh:
                toks = line.split()
                for idx in range(self.num_pc):
                    if idx < len(toks):
                        try:
                            tmp[idx] = float(toks[idx])
                        except ValueError:
                            pass
                rows.append(list(tmp))
        self.UD = np.array(rows, dtype=np.float64)

    def read_mean(self, path: str) -> None:
        vals = []
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    vals.append(float(parts[1]))
        self.means = np.array(vals, dtype=np.float64)

    def read_af(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 6:
                    chrom, _b, pos_s = parts[0], parts[1], parts[2]
                    af = float(parts[5])
                    self.known_af.setdefault(chrom, {})[int(pos_s)] = af

    @property
    def num_marker(self) -> int:
        return 0 if self.UD is None else len(self.UD)

    # ---- sanity check (IsSanityCheckOK, cpp:~480-560) ----

    def sanity_check(self) -> bool:
        v = self.viewer
        notice("Number of marker in Reference Matrix:%d", self.num_marker)
        notice("Number of marker shared with input file:%d", v.num_marker())
        ssq = 0.0
        for chrom, pos in self.pos_vec:
            if chrom in v.pos_index and pos in v.pos_index[chrom]:
                t = len(v.get_base(chrom, pos))
                ssq += t * t
        if v.effective_num_site:
            v.sd_depth = math.sqrt(ssq / v.effective_num_site
                                   - v.avg_depth * v.avg_depth)
        v.effective_num_site = 0
        for chrom, pos in self.pos_vec:
            if chrom in v.pos_index and pos in v.pos_index[chrom]:
                t = len(v.get_base(chrom, pos))
                if (t == 0 or t < v.avg_depth - 3 * v.sd_depth
                        or t > v.avg_depth + 3 * v.sd_depth):
                    continue
                v.effective_num_site += 1
        notice("Mean Depth:%f", v.avg_depth)
        notice("SD Depth:%f", v.sd_depth)
        notice("%d SNP markers remained after sanity check.", v.num_marker())
        return (v.num_marker() > 1000
                and v.num_marker() > self.num_marker * 0.1)

    # ---- vectorized likelihood ----

    def _prepare(self) -> None:
        """Collapse pileups to per-marker (class, qual) counts."""
        v = self.viewer
        n = self.num_marker
        active = np.zeros(n, dtype=bool)
        counts = np.zeros((n, N_CLASS * N_QBINS), dtype=np.float64)
        for i, (chrom, pos) in enumerate(self.pos_vec):
            if chrom not in v.pos_index or pos not in v.pos_index[chrom]:
                continue
            bases = v.get_base(chrom, pos)
            quals = v.get_qual(chrom, pos)
            if len(bases) == 0:
                continue
            if not self.is_sanity_check_disabled:
                d = len(bases)
                if (d < v.avg_depth - 3 * v.sd_depth
                        or d > v.avg_depth + 3 * v.sd_depth):
                    continue
            active[i] = True
            alt = self.choose_bed[chrom][pos][1].upper()
            for b, q in zip(bases, quals):
                if b in (".", ","):
                    cls = 0
                elif b.upper() == alt:
                    cls = 1
                else:
                    cls = 2
                qb = min(max(q - 33, 0), N_QBINS - 1)
                counts[i, cls * N_QBINS + qb] += 1
        self._active = active
        self._counts = counts[active]
        self._UD_act = self.UD[active]
        self._means_act = self.means[active]
        if self.is_af_known:
            af = np.zeros(n)
            for i, (chrom, pos) in enumerate(self.pos_vec):
                af[i] = self.known_af.get(chrom, {}).get(pos, 0.0)
            self._known_af_act = af[active]
        # precompute per-bin epsilon
        q = np.arange(N_QBINS, dtype=np.float64)
        self._eps = np.tile(np.power(10.0, q / -10.0), N_CLASS)
        cls = np.repeat(np.arange(N_CLASS), N_QBINS)
        self._lk_err = LK_ERR[:, cls]  # (3 genotypes, bins)
        self._lk_noerr = LK_NOERR[:, cls]
        self._device_llk = None
        if self.use_device:
            from .device_llk import DeviceLLK

            self._device_llk = DeviceLLK(
                self._counts, self._UD_act, self._means_act,
                known_af=(self._known_af_act if self.is_af_known else None),
                mesh=self.device_mesh, axis=self.device_axis)

    def compute_mix_llks(self, pc1, pc2, alpha: float) -> float:
        """ComputeMixLLKs (h:206-281), counts-factorized."""
        if self._device_llk is not None:
            return self._device_llk(pc1, pc2, alpha)
        pc1 = np.asarray(pc1, dtype=np.float64)
        pc2 = np.asarray(pc2, dtype=np.float64)
        if self.is_af_known:
            af1 = af2 = self._known_af_act.copy()
        else:
            af1 = (self._UD_act @ pc1 + self._means_act) / 2.0
            af2 = (self._UD_act @ pc2 + self._means_act) / 2.0
        af1 = np.clip(af1, MIN_AF, MAX_AF)
        af2 = np.clip(af2, MIN_AF, MAX_AF)
        gf1 = np.stack([(1 - af1) ** 2, 2 * af1 * (1 - af1), af1 ** 2], axis=1)
        gf2 = np.stack([(1 - af2) ** 2, 2 * af2 * (1 - af2), af2 ** 2], axis=1)

        # v[bin, g1, g2] then log
        e_mix = alpha * self._lk_err[:, None, :] + (1 - alpha) * self._lk_err[None, :, :]
        n_mix = (alpha * self._lk_noerr[:, None, :]
                 + (1 - alpha) * self._lk_noerr[None, :, :])
        v = e_mix * self._eps[None, None, :] + n_mix * (1 - self._eps[None, None, :])
        with np.errstate(divide="ignore"):
            logv = np.log(v)
        logv = np.maximum(logv, -1e300)  # avoid 0 * -inf = nan in the matmul
        # baseLK: (markers, 9)
        base_lk = self._counts @ logv.reshape(9, -1).T
        with np.errstate(over="ignore", under="ignore"):
            marker_lk = (np.exp(base_lk).reshape(-1, 3, 3)
                         * gf1[:, :, None] * gf2[:, None, :]).sum(axis=(1, 2))
        pos_mask = marker_lk > 0
        return float(np.log(marker_lk[pos_mask]).sum())

    # ---- fn.Evaluate (h:306-410) ----

    def _evaluate(self, v: np.ndarray) -> float:
        npc = self.num_pc
        if not self.is_heter:
            if self.is_pc_fixed:
                a = inv_logit(v[0])
                s = -self.compute_mix_llks(self._fix_pc, self._fix_pc2, a)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_alpha = a
            elif self.is_alpha_fixed:
                pc = list(v[:npc])
                s = -self.compute_mix_llks(pc, pc, self._fix_alpha)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_pc = pc
                    self.global_pc2 = list(pc)
            else:
                pc = list(v[:npc])
                a = inv_logit(v[npc])
                s = -self.compute_mix_llks(pc, pc, a)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_pc = pc
                    self.global_pc2 = list(pc)
                    self.global_alpha = a
        else:
            if self.is_pc_fixed:
                pc = list(v[:npc])
                a = inv_logit(v[npc])
                s = -self.compute_mix_llks(pc, self._fix_pc2, a)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_pc = pc
                    self.global_alpha = a
            elif self.is_alpha_fixed:
                pc = list(v[:npc])
                pc2 = list(v[npc:npc * 2])
                s = -self.compute_mix_llks(pc, pc2, self._fix_alpha)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_pc = pc
                    self.global_pc2 = pc2
            else:
                pc = list(v[:npc])
                pc2 = list(v[npc:npc * 2])
                a = inv_logit(v[npc * 2])
                s = -self.compute_mix_llks(pc, pc2, a)
                if s < self.llk1:
                    self.llk1 = s
                    self.global_pc = pc
                    self.global_pc2 = pc2
                    self.global_alpha = a
        if self.verbose:
            print(f"globalPC:{self.global_pc}\tglobalPC2:{self.global_pc2}"
                  f"\tglobalAlpha:{self.global_alpha}\tllk:{self.llk1}")
        return s

    # ---- OptimizeLLK (cpp:29-140) ----

    def optimize(self, output_prefix: str) -> None:
        self._prepare()
        mini = AmoebaMinimizer(self._evaluate)
        # fn.Initialize (h:283-299)
        self.global_pc = self._fix_pc = list(self.PC[1])
        self.global_pc2 = self._fix_pc2 = list(self.PC[1])
        self.global_alpha = self._fix_alpha = self.alpha
        self.llk1 = -self.compute_mix_llks(self._fix_pc, self._fix_pc2,
                                           self._fix_alpha)
        self.PC[0] = [0.01] * self.num_pc
        self.PC[1] = [0.01] * self.num_pc
        self.alpha = 0.03

        if not self.is_heter:
            if self.is_pc_fixed:
                print("Estimation from OptimizeHomoFixedPC:")
                self._optimize_homo_fixed_pc(mini)
            elif self.is_alpha_fixed:
                print("Estimation from OptimizeHomoFixedAlpha:")
                self._optimize_homo_fixed_alpha(mini)
            else:
                print("Estimation from OptimizeHomo:")
                self._optimize_homo(mini)
        else:
            if self.is_pc_fixed:
                print("Estimation from OptimizeHeterFixedPC:")
                self._optimize_homo(mini)  # OptimizeHeterFixedPC == Homo
            elif self.is_alpha_fixed:
                print("Estimation from OptimizeHeterFixedAlpha:")
                self.is_heter = False
                self._optimize_homo_fixed_alpha(mini)
                self.PC[1] = list(self.PC[0])
                self.global_pc2 = list(self.global_pc)
                self.is_heter = True
                self._optimize_heter_fixed_alpha(mini)
            else:
                print("Estimation from OptimizeHeter:")
                self.is_heter = False
                self._optimize_homo(mini)
                self.PC[1] = list(self.PC[0])
                self.global_pc2 = list(self.global_pc)
                self.is_heter = True
                self._optimize_heter(mini)
            if self.global_alpha >= 0.5:
                # swap only the first two PC components (cpp:71-74)
                for k in range(min(2, self.num_pc)):
                    self.global_pc[k], self.global_pc2[k] = (
                        self.global_pc2[k], self.global_pc[k])
        self.llk0 = -self.compute_mix_llks(self.global_pc, self.global_pc, 0.0)

        with open(output_prefix + ".Ancestry", "w") as fout:
            header = "PC\tContaminatingSample\tIntendedSample"
            print(header)
            fout.write(header + "\n")
            for i in range(self.num_pc):
                line = (f"{i + 1}\t{_fmt(self.global_pc[i])}\t"
                        f"{_fmt(self.global_pc2[i])}")
                print(line)
                fout.write(line + "\n")
        with open(output_prefix + ".Summary", "a") as fout:
            a = (self.global_alpha if self.global_alpha < 0.5
                 else 1 - self.global_alpha)
            fout.write(f"Contamination Level : {_fmt(a)}\n")

    def _optimize_homo(self, mini) -> bool:
        start = np.array(self.PC[0] + [logit(self.alpha)])
        mini.reset(self.num_pc + 1)
        mini.point = start
        ret = mini.minimize(self.epsilon)
        self.alpha = inv_logit(mini.point[self.num_pc])
        self.PC[0] = list(mini.point[: self.num_pc])
        return ret != FPMAX

    def _optimize_homo_fixed_alpha(self, mini) -> bool:
        start = np.array(self.PC[0], dtype=np.float64)
        mini.reset(self.num_pc)
        mini.point = start
        mini.minimize(self.epsilon)
        self.PC[0] = list(mini.point[: self.num_pc])
        return True

    def _optimize_homo_fixed_pc(self, mini) -> bool:
        start = np.array([logit(self.alpha)])
        mini.reset(1)
        mini.point = start
        ret = mini.minimize(self.epsilon)
        self.alpha = inv_logit(mini.point[0])
        return ret != FPMAX

    def _optimize_heter(self, mini) -> bool:
        start = np.array(self.PC[0] + self.PC[1] + [logit(self.alpha)])
        mini.reset(self.num_pc * 2 + 1)
        mini.point = start
        ret = mini.minimize(self.epsilon)
        self.alpha = inv_logit(mini.point[self.num_pc * 2])
        self.PC[0] = list(mini.point[: self.num_pc])
        self.PC[1] = list(mini.point[self.num_pc: self.num_pc * 2])
        return ret != FPMAX

    def _optimize_heter_fixed_alpha(self, mini) -> bool:
        start = np.array(self.PC[0] + self.PC[1])
        mini.reset(self.num_pc * 2)
        mini.point = start
        mini.minimize(self.epsilon)
        self.PC[0] = list(mini.point[: self.num_pc])
        self.PC[1] = list(mini.point[self.num_pc: self.num_pc * 2])
        return True


def _fmt(v: float) -> str:
    """C++ ostream default formatting for doubles."""
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.6g}"
