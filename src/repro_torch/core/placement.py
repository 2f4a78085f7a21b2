"""DanceMoE activation-aware expert placement (Sec. III-C).

Algorithm 1 — layer-wise expert *count* allocation: per-server budgets split
across layers proportionally to activation entropy, then rebalanced so every
layer's system-wide count reaches E_l (expert coverage).

Algorithm 2 — expert-to-server *assignment*: each server greedily takes its
top-N_{n,l} most frequent experts (the (1-1/e)-optimal greedy of Theorem 1),
then a coverage-repair loop places every unassigned expert by replacing the
least-used duplicate on the server currently holding the fewest duplicates.

Both operate on numpy (scheduler-side); ``build_ep_placement`` converts the
result into the stacked per-layer EPPlacement tables consumed by the SPMD
runtime.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.stats import entropy


# ---------------------------------------------------------------------------
# Algorithm 1: layer-wise expert count allocation
# ---------------------------------------------------------------------------

def allocate_expert_counts(experts_per_layer: np.ndarray,
                           capacity: np.ndarray,
                           entropies: np.ndarray,
                           max_per_layer: np.ndarray | None = None
                           ) -> np.ndarray:
    """Algorithm 1.

    experts_per_layer: [L] int — E_l.
    capacity:          [N] int — per-server expert-slot budget (M_n / m_e).
    entropies:         [L, N]  — v_{n,l}.
    max_per_layer:     [N] int or None — per-(server, layer) slot cap
                       (the SPMD runtime's S; None = no cap).
    Returns N_{n,l} as [L, N] int.
    """
    E_l = np.asarray(experts_per_layer, int)
    cap = np.asarray(capacity, int)
    v = np.asarray(entropies, float)
    L, N = v.shape
    assert len(E_l) == L and len(cap) == N

    # Step 1: initialize proportional to activation diversity.
    vsum = np.maximum(v.sum(0, keepdims=True), 1e-12)      # [1, N]
    counts = np.floor(cap[None, :] * v / vsum).astype(int)  # [L, N]
    counts = np.minimum(counts, E_l[:, None])
    if max_per_layer is not None:
        counts = np.minimum(counts, np.asarray(max_per_layer, int)[None, :])

    # Step 2: rebalance so each layer reaches its coverage count. Two moves
    # are possible: (a) spend spare server capacity left by the floor in
    # Step 1, (b) borrow a slot from the most over-provisioned layer on the
    # largest-memory server (the paper's loop), preserving memory limits.
    def cap_ok(l, n):
        if counts[l, n] >= E_l[l]:
            return False
        return max_per_layer is None or counts[l, n] < max_per_layer[n]

    for l in range(L):
        guard = 0
        while counts[l].sum() < E_l[l]:
            guard += 1
            if guard > 100000:
                raise RuntimeError("Algorithm 1: rebalancing did not "
                                   f"converge (layer {l})")
            used = counts.sum(0)                      # per-server slot usage
            placed = False
            for n in np.argsort(-cap):                # memory-descending
                if used[n] < cap[n] and cap_ok(l, n):
                    counts[l, n] += 1
                    placed = True
                    break
            if placed:
                continue
            surplus = counts.sum(1) - E_l
            surplus[l] = -10**9
            donor = int(np.argmax(surplus))
            if surplus[donor] <= 0:
                raise RuntimeError(
                    "Algorithm 1 cannot satisfy coverage: total memory too "
                    f"small for layer {l} ({counts[l].sum()} < {E_l[l]})")
            moved = False
            for n in np.argsort(-cap):
                if counts[donor, n] > 0 and cap_ok(l, n):
                    counts[donor, n] -= 1
                    counts[l, n] += 1
                    moved = True
                    break
            if not moved:
                raise RuntimeError(
                    f"Algorithm 1: rebalancing stuck (layer {l})")
    return counts


# ---------------------------------------------------------------------------
# Algorithm 2: expert-to-server assignment
# ---------------------------------------------------------------------------

def assign_experts_layer(n_counts: np.ndarray, freqs: np.ndarray
                         ) -> list[list[int]]:
    """Algorithm 2 for one layer.

    n_counts: [N] int — N_{n,l} from Algorithm 1.
    freqs:    [N, E]  — f_n^l(e).
    Returns per-server expert lists (len == n_counts[n]).
    """
    N, E = freqs.shape
    if int(np.sum(n_counts)) < E:
        raise ValueError(
            f"coverage infeasible: {int(np.sum(n_counts))} slots < {E} "
            "experts (Algorithm 1 must provide sum(N_n,l) >= E_l)")
    # greedy top-N_{n,l} by local activation frequency
    assign = [list(np.argsort(-freqs[n], kind="stable")[: n_counts[n]])
              for n in range(N)]

    def placement_count():
        c = np.zeros(E, int)
        for a in assign:
            for e in a:
                c[e] += 1
        return c

    guard = 0
    while True:
        guard += 1
        if guard > E * N + 10:
            raise RuntimeError("Algorithm 2: coverage repair did not converge")
        pc = placement_count()
        unassigned = [e for e in range(E) if pc[e] == 0]
        if not unassigned:
            break
        # servers ordered by number of duplicates ascending (paper line 7)
        dup_count = [sum(1 for e in assign[n] if pc[e] >= 2) for n in range(N)]
        made_progress = False
        for n in np.argsort(dup_count, kind="stable"):
            pc = placement_count()
            unassigned = [e for e in range(E) if pc[e] == 0]
            if not unassigned:
                break
            # most frequent unassigned expert according to this server
            e_new = max(unassigned, key=lambda e: freqs[n, e])
            if e_new in assign[n]:
                continue
            dups = [e for e in assign[n] if pc[e] >= 2]
            if not dups:
                continue
            e_rep = min(dups, key=lambda e: freqs[n, e])  # least-used dup
            assign[n][assign[n].index(e_rep)] = e_new
            made_progress = True
        if not made_progress:
            # fall back: force onto the server with the most slots
            pc = placement_count()
            unassigned = [e for e in range(E) if pc[e] == 0]
            n = int(np.argmax(n_counts))
            repl = [e for e in assign[n] if pc[e] >= 2] or assign[n]
            e_rep = min(repl, key=lambda e: freqs[n, e])
            assign[n][assign[n].index(e_rep)] = unassigned[0]
    return assign


# ---------------------------------------------------------------------------
# Full pipeline + SPMD table construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlacementPlan:
    """Scheduler-side placement: per-layer per-server expert sets."""
    assign: list[list[list[int]]]     # [L][N] -> expert ids
    counts: np.ndarray                # [L, N]
    num_experts: int

    def slot_tables(self, slots: int,
                    priority: np.ndarray | None = None) -> np.ndarray:
        """[L, N, slots] int32 slot_to_expert (-1 = empty).

        ``priority`` ([L, N, E], lower = hotter — e.g. the tier table from
        ``repro_torch.serving.tiers``) reorders each server's assignment before
        the slot truncation, so when a tiered plan assigns more experts
        than the engine has physical slots, the GPU-tier subset is what
        actually lands in the tables."""
        L = len(self.assign)
        N = len(self.assign[0])
        out = -np.ones((L, N, slots), np.int32)
        for l in range(L):
            for n in range(N):
                ex = self.assign[l][n]
                if priority is not None:
                    ex = sorted(ex, key=lambda e: (priority[l, n, e], e))
                ex = ex[:slots]
                out[l, n, :len(ex)] = ex
        return out

    def residency(self) -> np.ndarray:
        """[L, N, E] 0/1 — expert resident on server?"""
        L, N = self.counts.shape
        r = np.zeros((L, N, self.num_experts), np.float64)
        for l in range(L):
            for n in range(N):
                for e in self.assign[l][n]:
                    r[l, n, e] = 1.0
        return r


def iter_added_experts(old: "PlacementPlan", new: "PlacementPlan"):
    """Yield ``(layer, server, expert)`` for every placement entry present
    in ``new`` but absent from ``old`` — the entries a migration must
    actually move (removals are free: weights are dropped, not
    transferred). Deterministic order: (layer, server, ascending expert).
    Shared by the Eq.-3 estimate (``core.migration.migration_time``) and
    the staged transfer planner (``serving.net.plan_transfers``)."""
    for l, (lo, ln) in enumerate(zip(old.assign, new.assign)):
        for n, (ao, an) in enumerate(zip(lo, ln)):
            for e in sorted(set(an) - set(ao)):
                yield l, n, int(e)


def local_utility(assign_layer: list[list[int]], freqs: np.ndarray) -> float:
    """U_n summed over servers for one layer (Theorem 1's objective)."""
    return float(sum(freqs[n, list(set(a))].sum()
                     for n, a in enumerate(assign_layer)))


def remote_cost(plan: PlacementPlan, freqs: np.ndarray) -> float:
    """Proxy objective Eq. (2): expected remote invocations per token-layer,
    weighted by f_n^l(e). freqs: [L, N, E] (normalized per (l, n))."""
    res = plan.residency()
    return float((freqs * (1.0 - res)).sum())


def dancemoe_placement(freqs: np.ndarray, capacity: np.ndarray,
                       slots_cap: np.ndarray | None = None,
                       fill_spare: bool = True) -> PlacementPlan:
    """The full DanceMoE pipeline (Algorithm 1 + Algorithm 2).

    freqs:    [L, N, E] empirical activation frequencies.
    capacity: [N] per-server total expert-slot budget across all layers.
    slots_cap:[N] per-(server, layer) slot cap (SPMD S), optional.
    fill_spare: fill leftover per-layer slots with each server's next most
      frequent experts (extra replication at zero memory cost — this is what
      maximises U_n once coverage holds).
    """
    L, N, E = freqs.shape
    v = entropy(freqs, axis=-1)                     # [L, N]
    counts = allocate_expert_counts(
        np.full(L, E, int), capacity, v,
        max_per_layer=slots_cap)
    assign = []
    for l in range(L):
        a = assign_experts_layer(counts[l], freqs[l])
        if fill_spare and slots_cap is not None:
            for n in range(N):
                room = int(slots_cap[n]) - len(a[n])
                if room > 0:
                    extra = [e for e in np.argsort(-freqs[l, n], kind="stable")
                             if e not in a[n]][:room]
                    a[n] = a[n] + [int(e) for e in extra]
        assign.append(a)
    return PlacementPlan(assign=assign, counts=counts, num_experts=E)


def effective_dispatch_bytes(plan: PlacementPlan, freqs: np.ndarray,
                             tokens_per_server_layer: float,
                             hidden_bytes: float) -> float:
    """The placement-dependent ICI traffic the static HLO cannot see:
    expected bytes actually crossing the interconnect per step =
    remote fraction (Eq. 2) x dispatched activations x 2 (there and back).
    This is the quantity DanceMoE minimizes — reported alongside the static
    all-to-all operand size in EXPERIMENTS §Perf."""
    L = freqs.shape[0]
    remote_frac = remote_cost(plan, freqs) / max(
        freqs.shape[0] * freqs.shape[1], 1)
    return 2.0 * remote_frac * L * freqs.shape[1] \
        * tokens_per_server_layer * hidden_bytes


def build_ep_placement(plan: PlacementPlan, slots: int, mesh_distance=None,
                       priority: np.ndarray | None = None):
    """Convert a PlacementPlan into stacked per-layer EPPlacement tables
    ([L, n_ep, ...]) for the SPMD runtime. ``priority`` (see
    ``PlacementPlan.slot_tables``) keeps GPU-tier experts in the physical
    slots when the plan over-assigns against a tier hierarchy."""
    from repro_torch.models.moe import EPPlacement, placement_from_tables
    tables = plan.slot_tables(slots, priority=priority)   # [L, N, S]
    per_layer = [placement_from_tables(tables[l], mesh_distance,
                                       num_experts=plan.num_experts)
                 for l in range(tables.shape[0])]
    return EPPlacement(*(np.stack(xs) for xs in zip(*per_layer)))
