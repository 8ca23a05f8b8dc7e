"""MCMC (simulated-annealing) strategy search.

Reference: FFModel::mcmc_optimize (src/runtime/model.cc:3285-3356) —
start from data-parallel, repeatedly `rewrite()` a random op's parallel
config (model.cc:3260-3283), simulate, and Metropolis-accept with
probability exp(-alpha * delta).

The search space (mesh-realizable by construction): a mesh factorization {data, model, expert} of the device
count plus per-op ShardConfigs — channel (linear out-dim / attention
heads / conv out-channels), attribute (embedding vocab), expert (MoE).
Candidates that fail shape/degree propagation are pruned by the
ShapeError the op shape rules raise.  Cost comes from the
simulator; the memory-aware mode adds the reference's lambda-weighted
memory objective (graph.cc:2056-2131 style) when the strategy exceeds
the per-device HBM budget.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

from ..fftype import OperatorType
from ..logger import search_logger as slog
from ..obs.metrics import emit_counters
from ..ops.op import ShardConfig
from ..strategy import Strategy
from .evaluator import IncrementalEvaluator
from .graph import Graph


def search_stage_candidates(cfg) -> Tuple[int, ...]:
    """ZeRO ladder stages a search may choose (docs/PERF.md).  Pinned
    to cfg.zero_stage unless the memory-aware search is on — then every
    stage >= the configured floor competes, so memory-pressured models
    land on 2/3 (grad- and weight-resident HBM / dp at the price of
    per-layer all-gather traffic) while unconstrained ones keep 0/1.
    Shared by the MCMC and Unity searches."""
    if not cfg.memory_search:
        return (cfg.zero_stage,)
    return tuple(s for s in (0, 1, 2, 3) if s >= cfg.zero_stage)


def search_remat_enabled(cfg) -> bool:
    """Whether the searches may choose per-segment remat plans
    (docs/PERF.md "Searched rematerialization").  Like the ZeRO ladder,
    the dimension opens only under the memory-aware search; a global
    --remat floor does NOT close it — the search can still find a
    cheaper partial plan (a plan rides the strategy and overrides the
    bool in the executor)."""
    return bool(cfg.memory_search)


def remat_stats(strategy) -> Dict[str, object]:
    """The search_stats payload describing a winner's remat plan: the
    ON segment indices ("" when none) and their count."""
    plan = getattr(strategy, "remat", None)
    return {
        "remat": ",".join(str(i) for i in plan) if plan else "",
        "remat_segments_on": len(plan or ()),
    }


def _factorizations(n: int, allow_expert: bool = True) -> List[Tuple[int, int, int]]:
    """(data, model, expert) triples with product n.  allow_expert=False
    drops ep>1 triples — the single source of the 'expert axis only with
    expert-shardable ops' invariant shared by the MCMC and Unity
    searches."""
    out = []
    for d in range(1, n + 1):
        if n % d:
            continue
        rest = n // d
        for m in range(1, rest + 1):
            if rest % m:
                continue
            e = rest // m
            if e > 1 and not allow_expert:
                continue
            out.append((d, m, e))
    return out


class _Candidate:
    """Ops whose ShardConfig the search may mutate, with legal degrees."""

    def __init__(self, op, kind: str, max_sizes: Dict[str, int]):
        self.name = op.name
        self.kind = kind  # "channel" | "attribute" | "expert"
        self.max_sizes = max_sizes  # e.g. {"channel": num_heads}


def find_candidates(graph: Graph) -> List[_Candidate]:
    cands = []
    for op in graph.ops:
        t = op.op_type
        if t == OperatorType.LINEAR:
            limit = getattr(op.params, "out_channels", None) or getattr(
                op.params, "out_dim", 0
            )
            cands.append(_Candidate(op, "channel", {"channel": limit}))
        elif t == OperatorType.CONV2D:
            cands.append(_Candidate(op, "channel", {"channel": op.params.out_channels}))
        elif t == OperatorType.MULTIHEAD_ATTENTION:
            cands.append(_Candidate(op, "channel", {"channel": op.params.num_heads}))
        elif t == OperatorType.EMBEDDING:
            cands.append(
                _Candidate(op, "attribute", {"attribute": op.params.num_entries})
            )
        elif t in (OperatorType.GROUP_BY,):
            cands.append(_Candidate(op, "expert", {"expert": op.params.n}))
    return cands


class MCMCSearch:
    def __init__(
        self,
        graph: Graph,
        num_devices: int,
        simulator_factory,
        budget: int = 100,
        alpha: float = 0.05,
        memory_budget: Optional[int] = None,
        memory_lambda: float = 1.0,
        seed: int = 0,
        propagate: bool = True,
        propagation_chance: float = 0.25,
        continue_chance: float = 0.7,
        use_eval_cache: bool = True,
        zero_stages: Optional[Tuple[int, ...]] = None,
        remat_search: bool = False,
        registry=None,
    ):
        # obs.metrics.MetricsRegistry (or None): the final counters also
        # land in the run's telemetry, not only on the log line
        self.registry = registry
        self.graph = graph
        self.n = num_devices
        self.simulator_factory = simulator_factory
        # ONE simulator per search, not one per candidate: the factory
        # still runs once so fitted-constant loading is unchanged, and
        # its (node_key)->cost / OpTerms caches persist across
        # evaluations (reference keeps one simulator for the whole
        # search, simulator.cc:550-560)
        self.simulator = simulator_factory()
        self.evaluator = IncrementalEvaluator(
            graph, self.simulator, training=True, use_cache=use_eval_cache
        )
        self.budget = budget
        self.alpha = alpha
        self.memory_budget = memory_budget
        self.memory_lambda = memory_lambda
        self.rng = random.Random(seed)
        # FF_USE_PROPAGATE (reference model.cc:3180-3258): a rewrite may
        # spread the changed op's config to adoptable neighbors, walking
        # while randf() < CONTINUE_PROPAGATION_CHANCE.  Our per-op state
        # is the shard flag, so the analogue copies the flipped value to
        # structurally identical candidates (same kind+limits — the 12
        # identical encoder layers of a deep net), which is the case the
        # reference optimization accelerates.
        self.propagate = propagate
        self.propagation_chance = propagation_chance
        self.continue_chance = continue_chance
        # ZeRO ladder stages the chain may move between.  A singleton
        # fixes the stage (no stage moves; candidates are stamped with
        # it); None also disables moves but leaves candidates at
        # zero_stage=None, costing under the simulator's own stage.
        self.zero_stages = tuple(zero_stages) if zero_stages else None
        # multi-slice hierarchy (topology/hierarchy.py): on a
        # SliceHierarchy the chain gains a placement move, re-picking
        # the mesh axis that spans the slices; other machines keep the
        # move distribution as it was
        machine = self.simulator.machine
        self.slices = max(1, int(getattr(machine, "slices", 1) or 1))
        self._hier = self.slices > 1 and hasattr(machine, "collective_cost")
        self.candidates = find_candidates(graph)
        has_experts = any(c.kind == "expert" for c in self.candidates)
        self.factorizations = _factorizations(
            num_devices, allow_expert=has_experts
        )
        # searched remat (docs/PERF.md): the chain gains a FLIP-SEGMENT
        # move — toggle one pure single-tensor-boundary segment's remat
        # bit.  The flippable universe comes from the FRONTEND graph's
        # segmentation (applied graphs may split slightly differently
        # around inserted parallel ops; the evaluator always prices a
        # plan against the candidate's own applied segmentation, so the
        # move space is a proposal distribution, not a contract).
        self.remat_search = remat_search
        self.remat_flippable: List[int] = []
        if remat_search:
            from ..sim.simulator import MAX_REMAT_SEGMENTS
            from ..sim.simulator import remat_segments as _remat_segments

            self.remat_flippable = [
                i for i, (_, pure) in enumerate(
                    _remat_segments(graph.topo_order())
                ) if pure
            ][:MAX_REMAT_SEGMENTS]
        self.history: List[Tuple[int, float]] = []

    # -- strategy construction ------------------------------------------
    def _mesh_axes(self, dp: int, tp: int, ep: int) -> Dict[str, int]:
        axes = {}
        if dp > 1:
            axes["data"] = dp
        if tp > 1:
            axes["model"] = tp
        if ep > 1:
            axes["expert"] = ep
        if not axes:
            axes["data"] = 1
        return axes

    def _build(self, dp: int, tp: int, ep: int,
               flags: Dict[str, bool],
               zero_stage: Optional[int] = None,
               placement: Optional[str] = None,
               remat: Optional[Tuple[int, ...]] = None) -> Strategy:
        mesh_axes = self._mesh_axes(dp, tp, ep)
        if placement is not None:
            # a factorization move can strand the placement on an axis
            # the new mesh lacks (or the slices no longer divide): None
            # is resolve_placement's default
            from ..topology.hierarchy import legal_placements

            if placement not in legal_placements(mesh_axes, self.slices):
                placement = None
        s = Strategy(mesh_axes=mesh_axes, zero_stage=zero_stage,
                     placement=placement,
                     remat=sorted(remat) if remat is not None else None)
        if dp > 1:
            s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
        # Megatron column->row pairing: a channel(tp)-sharded linear
        # leaves its output feature-sharded; a DIRECTLY consuming linear
        # must contract over that sharding (reduction=tp), not re-shard
        # channel — channel+channel on adjacent linears is an illegal
        # degree blow-up (the reference expresses the same pairing as
        # create_partition_linear_combine vs create_replicate_linear_
        # combine xfers, substitution.cc:1755-1820).  Walking topo order
        # alternates col,row,col,row through a sharded run.
        by_name = {op.name: op for op in self.graph.ops}
        is_col = {}  # name -> got channel=tp (output feature-sharded)
        for c in self.candidates:
            if not flags.get(c.name):
                continue
            if c.kind == "channel" and tp > 1 and c.max_sizes["channel"] % tp == 0:
                op = by_name.get(c.name)
                prod = (op.inputs[0].owner_op
                        if op is not None and op.inputs else None)
                while prod is not None and prod.op_type in (
                    OperatorType.ELEMENT_UNARY, OperatorType.DROPOUT,
                ):
                    prod = (prod.inputs[0].owner_op
                            if prod.inputs else None)
                if (op is not None and op.op_type == OperatorType.LINEAR
                        and prod is not None and is_col.get(prod.name)):
                    s.shard_configs[c.name] = ShardConfig(reduction=tp)
                else:
                    s.shard_configs[c.name] = ShardConfig(channel=tp)
                    if op is not None and op.op_type == OperatorType.LINEAR:
                        is_col[c.name] = True
            elif c.kind == "attribute" and tp > 1 and c.max_sizes["attribute"] % tp == 0:
                s.shard_configs[c.name] = ShardConfig(attribute=tp)
            elif c.kind == "expert" and ep > 1 and c.max_sizes["expert"] % ep == 0:
                s.shard_configs[c.name] = ShardConfig(expert=ep)
        return s

    # -- cost ------------------------------------------------------------
    def evaluate(self, strategy: Strategy) -> float:
        res = self.evaluator.evaluate(strategy)
        if res is None:  # ShapeError / unfactorable view -> illegal
            return math.inf
        cost = res.total_time
        # per_device_memory is lazy — the liveness scan only runs when a
        # budget makes the search actually consume it
        if self.memory_budget is not None and res.per_device_memory > self.memory_budget:
            over = res.per_device_memory / self.memory_budget - 1.0
            cost *= 1.0 + self.memory_lambda * over
        return cost

    @property
    def stats(self):
        """EvalStats for the whole search (memo/delta/full counters)."""
        return self.evaluator.stats

    # -- main loop (reference model.cc:3285-3356) ------------------------
    def optimize(self) -> Strategy:
        dp, tp, ep = self.n, 1, 1
        flags: Dict[str, bool] = {}
        # stage moves only when the ladder is actually searchable; the
        # chain starts at the ladder's floor (the configured stage)
        stage_moves = (
            self.zero_stages
            if self.zero_stages and len(self.zero_stages) > 1 else None
        )
        stage = self.zero_stages[0] if self.zero_stages else None
        placement = None  # resolve_placement's default
        remat: Optional[Tuple[int, ...]] = None  # not chosen
        current = self._build(dp, tp, ep, flags, stage, placement, remat)
        current_cost = self.evaluate(current)
        best, best_cost = current, current_cost
        self.best_iteration = -1  # evals needed to reach the winner
        state = (dp, tp, ep, dict(flags), stage, placement, remat)
        remat_moves = bool(self.remat_search and self.remat_flippable)
        for it in range(self.budget):
            ndp, ntp, nep, nflags = state[0], state[1], state[2], dict(state[3])
            nstage, nplacement, nremat = state[4], state[5], state[6]
            move = self.rng.random()
            # the placement move (on a hierarchy) and the remat
            # flip-segment move carve their windows below the existing
            # thresholds (off and roff shift them), so without them the
            # stage/factorization move probabilities are the historical
            # ones
            off = 0.12 if self._hier else 0.0
            roff = 0.10 if remat_moves else 0.0
            if self._hier and move < off:
                # placement move: re-pick the axis that spans the slices
                # (the sharding is unchanged, so the evaluator re-sums
                # cached OpTerms under the new tiers); None = default
                from ..topology.hierarchy import legal_placements

                mesh = self._mesh_axes(ndp, ntp, nep)
                nplacement = self.rng.choice(
                    [None] + legal_placements(mesh, self.slices))
            elif remat_moves and move < off + roff:
                # flip-segment move (docs/PERF.md "Searched
                # rematerialization"): toggle one pure segment's remat
                # bit.  The applied graph is plan-invariant, so the
                # evaluator re-sums cached OpTerms — a cheap move like
                # the stage one.
                cur = set(nremat or ())
                seg = self.rng.choice(self.remat_flippable)
                cur.symmetric_difference_update({seg})
                nremat = tuple(sorted(cur))
            elif stage_moves is not None and move < off + roff + 0.15:
                # ZeRO-stage move: re-rung the ladder (the candidate's
                # sharding is unchanged, so the evaluator re-sums
                # cached OpTerms under the new stage — a cheap move)
                nstage = self.rng.choice(stage_moves)
            elif move < off + roff + 0.25 or not self.candidates:
                ndp, ntp, nep = self.rng.choice(self.factorizations)
            elif (self.propagate
                  and move < off + roff + 0.25
                  + 0.75 * self.propagation_chance):
                # propagate move (reference FFModel::propagate,
                # model.cc:3180-3258): spread a randomly selected op's
                # CURRENT config to a walk of adoptable neighbors —
                # here, structurally identical candidates — continuing
                # while randf() < CONTINUE_PROPAGATION_CHANCE.  This
                # harmonizes a half-sharded run of identical layers in
                # one accepted move instead of one flip per eval.
                c = self.rng.choice(self.candidates)
                val = nflags.get(c.name, False)
                sig = (c.kind, tuple(sorted(c.max_sizes.items())))
                peers = [
                    p for p in self.candidates
                    if p.name != c.name
                    and (p.kind, tuple(sorted(p.max_sizes.items()))) == sig
                ]
                for p in peers:  # graph order, like the BFS walk
                    nflags[p.name] = val
                    if self.rng.random() >= self.continue_chance:
                        break
            else:
                c = self.rng.choice(self.candidates)
                nflags[c.name] = not nflags.get(c.name, False)
            if ((ndp, ntp, nep) == state[:3] and nflags == state[3]
                    and nstage == state[4] and nplacement == state[5]
                    and nremat == state[6]):
                continue  # no-op move (e.g. propagate with no peers to
                # change): don't burn a simulator eval on it
            cand = self._build(ndp, ntp, nep, nflags, nstage, nplacement,
                               nremat)
            cost = self.evaluate(cand)
            self.history.append((it, cost))
            if cost < current_cost or (
                math.isfinite(cost)
                and self.rng.random()
                < math.exp(-self.alpha * (cost - current_cost) / max(1e-12, current_cost))
            ):
                current, current_cost = cand, cost
                state = (ndp, ntp, nep, nflags, nstage, nplacement, nremat)
                if cost < best_cost:
                    best, best_cost = cand, cost
                    self.best_iteration = it
        # search observability: counters ride on the returned strategy
        # so benchmarks and callers can track cache effectiveness
        best.search_stats = self.evaluator.stats.as_dict()
        # the winner's per-segment remat plan ("" when no plan chosen)
        best.search_stats.update(remat_stats(best))
        # the winner's placement ("" off a hierarchy) and whether its
        # grad reduction is hierarchical
        from ..topology.hierarchy import placement_stats

        best.search_stats.update(placement_stats(
            best, self.slices if self._hier else 1))
        # underlying cache layers (term decomposition + op-cost cache)
        best.search_stats["term_hits"] = self.simulator.term_hits
        best.search_stats["term_misses"] = self.simulator.term_misses
        best.search_stats["op_cost_hits"] = self.simulator.cost_model.cost_hits
        emit_counters(slog, "mcmc eval stats", best.search_stats,
                      registry=self.registry, group="search/mcmc")
        return best


def make_search_simulator(cfg, machine, cost_model):
    """The ONE place an FFConfig becomes the Simulator configuration
    candidates are costed with: fitted overlap constants (when a
    calibration is persisted), parameter-sync mode, remat, the ZeRO-1
    update flags and the grad-sync bucket of a multi-slice run."""
    from ..sim.calibrate import load_overlap_constants
    from ..sim.simulator import Simulator, device_name
    from .unity import _sync_mode

    fitted = load_overlap_constants(backend=device_name(cfg.device))
    kw = {}
    if fitted is not None:
        kw["overlap_fraction"] = fitted["overlap_fraction"]
        kw["compute_scale"] = fitted.get("compute_scale", 1.0)
    return Simulator(
        machine,
        cost_model,
        sync_overlap_fraction=(
            fitted["sync_overlap_fraction"] if fitted is not None
            else (0.7 if cfg.search_overlap_backward_update else None)
        ),
        **kw,
        parameter_sync=_sync_mode(cfg.parameter_sync),
        remat=cfg.remat,
        zero_stage=cfg.zero_stage,
        wus_axis=cfg.wus_axis,
        dcn_bucket_bytes=float(cfg.dcn_bucket_mb) * 2**20,
    )


def mcmc_optimize(model, num_devices: int) -> Strategy:
    """Entry used by FFModel.compile (config-driven)."""
    from ..sim.machine_model import make_machine_model
    from ..sim.simulator import make_cost_model

    cfg = model.config
    machine = make_machine_model(cfg, num_devices)

    # one shared cost model: the (node_key)->cost cache must persist
    # across candidate evaluations (reference simulator.cc:550-560)
    cost_model = make_cost_model(cfg, machine)

    def sim_factory():
        return make_search_simulator(cfg, machine, cost_model)

    search = MCMCSearch(
        model.layers,
        num_devices,
        sim_factory,
        budget=max(1, cfg.search_budget),
        alpha=cfg.search_alpha,
        memory_budget=cfg.memory_per_device if cfg.memory_search else None,
        memory_lambda=cfg.memory_lambda,
        seed=cfg.seed,
        propagate=cfg.search_propagate,
        use_eval_cache=cfg.search_eval_cache,
        zero_stages=search_stage_candidates(cfg),
        remat_search=search_remat_enabled(cfg),
        registry=getattr(getattr(model, "telemetry", None), "metrics", None),
    )
    best = search.optimize()
    best.search_stats.update(cost_model.stats())
    # surface the ZeRO stage the winner was scored under (and the
    # legacy bool it subsumes)
    chosen = best.zero_stage if best.zero_stage is not None else cfg.zero_stage
    best.search_stats["zero_stage"] = int(chosen)
    best.search_stats["weight_update_sharding"] = chosen >= 1
    cost_model.save_persistent()
    return best
