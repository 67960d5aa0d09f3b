"""The fused tuning engine: propose -> dedup -> evaluate -> observe -> best.

Counterpart of `uptune_tpu/engine/fused.py`.  The JAX package runs the
whole step as one jitted XLA program under `lax.scan`; here a step is
eager PyTorch on one device, and `run` is a Python loop.  One step:

1. every arm proposes its natural batch and the batches concatenate;
2. the batch is hashed (`Space.hash_batch`);
3. the hashes are checked against the device-resident history and
   deduplicated within the batch;
4. the candidates are evaluated by the device objective, or by an
   `eval_fn` (a GP surrogate's acquisition, `engine/batched.py`);
5. the novel rows are merged into the history — on the card through the
   hand-written merge kernel (`ops/dedup.py`, `csrc/merge.cu`), once per
   commit;
6. the best folds in (and, with `exchange=`, is exchanged across
   instances) and each arm observes its slice.  `commit` is
   `commit_head` (up to the best), the exchange, then `commit_tail`
   (credit and observe), so that the batched engine can vmap the two
   halves and exchange across the stacked best between them.

`propose_topk` ranks a proposal epoch with the fused acquisition top-k
instead of evaluating it.

Randomness: the state carries a key (`EngineState.key`, an `rng.key`),
as the JAX state does, and every draw is a function of it: `propose`
splits the state's key into the key it returns and the key of its draws,
and `commit` draws the arms' observe from the key `propose` returned and
keeps it as the new state's key.  So a state is a value: proposing twice
from one state gives the same batch, nothing is updated in place, and
`torch.func.vmap` runs `propose` and `commit` over stacked states
(`engine/batched.py`).  `propose` and `commit` take optional pre-made
draws (`draw_propose` / `draw_observe` make them from a key) so a test
can feed the numbers JAX drew.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .. import rng
from ..device import DeviceLike, resolve_device
from ..driver.history import History, HistState, dup_source
from ..space.spec import CandBatch, Space, concat_cands
from ..techniques.base import Best, Technique, get_technique

# objective over decoded values: (vals [B, D] f32, perms tuple [B, s_k])
# -> [B], on the engine's device
DeviceObjective = Callable[[torch.Tensor, Tuple[torch.Tensor, ...]],
                           torch.Tensor]
# the cross-instance best exchange: Best -> Best
Exchange = Callable[[Best], Best]


class EngineState(NamedTuple):
    tstates: Tuple              # per-arm technique states
    best: Best
    hist: HistState
    key: torch.Tensor           # [2] int64 (rng.key): the next draws' key
    evals: torch.Tensor         # scalar i32: novel evaluations so far
    acqs: torch.Tensor          # scalar i32: total candidates processed
    arm_pulls: torch.Tensor     # [n_arms] i32
    arm_hits: torch.Tensor      # [n_arms] i32: steps where arm held new best


class CommitHead(NamedTuple):
    """What the first half of a commit hands the second: the oriented
    QoR, the best with the batch folded in (before any exchange), the
    merged history and the count of novel rows."""
    qor: torch.Tensor           # [B] f32
    best: Best
    hist: HistState
    n_new: torch.Tensor         # scalar i32


def default_arms(scale: int = 1) -> List[Technique]:
    """The AUCBanditMetaTechniqueA portfolio members, populations scaled
    by `scale`."""
    from ..techniques.de import DifferentialEvolution
    from ..techniques.evolutionary import GreedyMutation
    from ..techniques.simplex import NelderMead

    return [
        DifferentialEvolution(population_size=30 * scale, cr=0.2,
                              name="DifferentialEvolutionAlt"),
        GreedyMutation(batch=32 * scale, name="UniformGreedyMutation"),
        GreedyMutation(batch=32 * scale, sigma=0.1, mutation_rate=0.3,
                       name="NormalGreedyMutation"),
        NelderMead(init_style="random", name="RandomNelderMead"),
    ]


class FusedEngine:
    """space + arms + device objective -> (init, propose, commit, step,
    run) on one device (default ``"cuda"``)."""

    def __init__(self, space: Space, objective: DeviceObjective,
                 arms: Optional[Sequence[Technique]] = None,
                 history_capacity: int = 1 << 15, dedup: bool = True,
                 sense: str = "min", device: DeviceLike = "cuda"):
        if sense not in ("min", "max"):
            raise ValueError(f"sense must be 'min' or 'max', got {sense!r}")
        self.device = resolve_device(device)
        self.space = space
        self.sign = 1.0 if sense == "min" else -1.0
        self.objective = objective
        if arms is None:
            arms = default_arms()
        elif arms and isinstance(arms[0], str):
            arms = [get_technique(n) for n in arms]
        self.arms: List[Technique] = [t for t in arms if t.supports(space)]
        if not self.arms:
            raise ValueError("no arm supports this space")
        self.batches = [t.natural_batch(space) for t in self.arms]
        self.total_batch = sum(self.batches)
        self.history = History(history_capacity, device=self.device)
        self.dedup = dedup
        # elements each draw phase took last time: a stream hashes that
        # many at once (a size, never a result)
        self._hints = {}

    # ------------------------------------------------------------------
    def init(self, seed: Union[int, torch.Tensor] = 0) -> EngineState:
        """A fresh state from an integer seed or a key (`rng.key`, or a
        row of `BatchedEngine.instance_seeds`).  The arms' initial draws
        come from the key's stream; the key becomes the state's."""
        key = (seed if isinstance(seed, torch.Tensor)
               else rng.key(seed, self.device))
        space = self.space
        tstates = self._draw(key, "init", lambda gen: tuple(
            t.init_state(space, t.draw_init(space, gen)) for t in self.arms))
        i32 = dict(dtype=torch.int32, device=self.device)
        n = len(self.arms)
        return EngineState(
            tstates, Best.empty(space, self.device), self.history.init(),
            key, torch.zeros((), **i32), torch.zeros((), **i32),
            torch.zeros((n,), **i32), torch.zeros((n,), **i32))

    # ------------------------------------------------------------------
    def _draw(self, key: torch.Tensor, phase: str, draw: Callable):
        """`draw(gen)` on a stream of `key` sized by this phase's last
        draw (`rng.hinted`)."""
        return rng.hinted(key, self._hints, phase, draw)

    def draw_propose(self, key: torch.Tensor) -> tuple:
        """Every arm's propose draws, from the draw key `propose` splits
        off the state's key."""
        return self._draw(key, "propose", lambda gen: tuple(
            t.draw_propose(self.space, gen) for t in self.arms))

    def draw_observe(self, key: torch.Tensor) -> tuple:
        """Every arm's observe draws, from the key `propose` returned."""
        return self._draw(key, "observe", lambda gen: tuple(
            t.draw_observe(self.space, gen) for t in self.arms))

    def propose(self, state: EngineState, draws: Optional[tuple] = None
                ) -> Tuple[tuple, CandBatch, torch.Tensor]:
        """The proposal half of a step: every arm emits its batch, the
        batches concatenate.  A function of the state alone.  Returns
        `(new_tstates, cands, key)` for `commit()`.  `draws` (per arm)
        default to those of the draw key split off the state's key."""
        key, kdraw = rng.split(state.key, 2).unbind(-2)
        if draws is None:
            draws = self.draw_propose(kdraw)
        new_tstates, cands_list = [], []
        for t, st, d in zip(self.arms, state.tstates, draws):
            st2, c = t.propose(self.space, st, state.best, d)
            new_tstates.append(st2)
            cands_list.append(c)
        cands = (concat_cands(cands_list) if len(cands_list) > 1
                 else cands_list[0])
        return tuple(new_tstates), cands, key

    def evaluate(self, cands: CandBatch) -> torch.Tensor:
        """The raw (un-oriented) objective on decoded values."""
        return self.objective(self.space.decode_scalars(cands.u),
                              cands.perms)

    def propose_topk(self, state: EngineState, acq, k: int,
                     draws: Optional[tuple] = None
                     ) -> Tuple[tuple, CandBatch, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
        """Propose one epoch and rank it with the fused acquisition
        top-k.  `acq` is a `StatefulEval` from `surrogate_eval_fn(...,
        impl="fused")`.  Returns `(new_tstates, cands, key, vals, idx)`:
        the [k] utilities, descending, and their candidate rows; the
        caller gathers `cands[idx]`.  `draws` as for `propose`."""
        if acq.topk is None:
            raise ValueError("acq has no topk (need impl='fused')")
        new_tstates, cands, key = self.propose(state, draws)
        vals, idx = acq.topk(cands, acq.aux, k)
        return new_tstates, cands, key, vals, idx

    def step(self, state: EngineState, eval_fn=None,
             exchange: Optional[Exchange] = None) -> EngineState:
        """One fused step: propose, evaluate, commit.  `eval_fn(cands) ->
        raw` replaces the objective call (a surrogate evaluator, for
        example); `exchange(best) -> best` is the cross-instance best
        exchange, identity when absent."""
        new_tstates, cands, key = self.propose(state)
        raw = self.evaluate(cands) if eval_fn is None else eval_fn(cands)
        return self.commit(state, new_tstates, cands, raw, key, exchange)

    # ------------------------------------------------------------------
    def commit(self, state: EngineState, new_tstates, cands: CandBatch,
               raw: torch.Tensor, key: torch.Tensor,
               exchange: Optional[Exchange] = None,
               draws: Optional[tuple] = None) -> EngineState:
        """The commit half of a step: orient and clean the measured QoR,
        dedup against the history and merge the novel rows into it, fold
        the batch into the best, exchange it (`exchange(best) -> best`,
        identity when absent), attribute per-arm credit and run every
        arm's observe.  `raw` is the un-oriented objective for `cands`,
        `key` the one `propose` returned; `draws` (per arm, for observe)
        default to those of `key`."""
        head = self.commit_head(state, new_tstates, cands, raw)
        if exchange is not None:
            head = head._replace(best=exchange(head.best))
        return self.commit_tail(state, new_tstates, cands, head, key, draws)

    def commit_head(self, state: EngineState, new_tstates, cands: CandBatch,
                    raw: torch.Tensor) -> CommitHead:
        """The commit up to the best: orient and clean the QoR, dedup,
        merge the novel rows into the history, fold the batch into the
        best."""
        B = cands.batch
        dev = self.device
        qor = self.sign * raw
        qor = torch.where(torch.isfinite(qor), qor,
                          float("inf")).to(torch.float32)

        if self.dedup:
            hashes = self.space.hash_batch(cands)
            found, _ = self.history.contains(state.hist, hashes)
            src = dup_source(hashes)
            novel = (src == torch.arange(B, device=dev)) & ~found
            hist = self.history.insert(state.hist, hashes, qor, novel)
            n_new = novel.sum().to(torch.int32)
        else:
            hist = state.hist
            n_new = torch.tensor(B, dtype=torch.int32, device=dev)
        return CommitHead(qor, state.best.update(cands, qor), hist, n_new)

    def commit_tail(self, state: EngineState, new_tstates, cands: CandBatch,
                    head: CommitHead, key: torch.Tensor,
                    draws: Optional[tuple] = None) -> EngineState:
        """The commit from the (exchanged) best on: per-arm credit and
        every arm's observe, with `draws` defaulting to those of `key`."""
        if draws is None:
            draws = self.draw_observe(key)
        qor, best = head.qor, head.best
        prev_best = state.best.qor
        step_min = torch.min(qor)
        hits, tstates_out = [], []
        off = 0
        for t, st2, b, d in zip(self.arms, new_tstates, self.batches, draws):
            sl = slice(off, off + b)
            cq = qor[sl]
            arm_best = torch.min(cq)
            hits.append((arm_best < prev_best) & (arm_best <= step_min))
            tstates_out.append(
                t.observe(self.space, st2, cands[sl], cq, best, d))
            off += b

        return EngineState(
            tuple(tstates_out), best, head.hist, key,
            state.evals + head.n_new, state.acqs + cands.batch,
            state.arm_pulls + 1,
            state.arm_hits + torch.stack(hits).to(torch.int32))

    # ------------------------------------------------------------------
    def run(self, state: EngineState, n_steps: int, eval_fn=None,
            exchange: Optional[Exchange] = None) -> EngineState:
        """n_steps fused steps (a Python loop; the JAX package scans)."""
        for _ in range(n_steps):
            state = self.step(state, eval_fn, exchange)
        return state

    def run_traced(self, state: EngineState, n_steps: int
                   ) -> Tuple[EngineState, torch.Tensor]:
        """Like run() but also returns the best-so-far trace [n_steps] in
        the user's orientation."""
        trace = []
        for _ in range(n_steps):
            state = self.step(state)
            trace.append(self.sign * state.best.qor)
        return state, torch.stack(trace)

    def best_config(self, state: EngineState):
        return self.space.to_configs(state.best.as_batch(1))[0]

    def best_qor(self, state: EngineState) -> float:
        # a host read: the reporting boundary, never inside a step
        return float(self.sign * state.best.qor)
