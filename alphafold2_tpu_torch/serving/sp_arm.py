"""The SP serving arm: schedule choice and residency pricing per bucket
(counterpart of alphafold2_tpu/serving/sp_arm.py, the same names).

With `ServingConfig.sp_shards > 1` the engine builds bucket executables
whose trunk runs over a one-axis mesh of shards (parallel/mesh.py), and
this module decides, per length bucket, which cut to take:

  `"dense"`   the replicated trunk: no collectives, the right answer for
              every bucket that fits one device;
  `"sp_msa"`  shard the MSA ROW axis only (`msa_sharded_trunk_apply`): MSA
              residency and attention FLOPs divide by the shard count,
              the pair grid stays whole;
  `"sp_seq"`  shard the SEQUENCE (pair rows and MSA rows, `sp_trunk_apply`,
              the MSA<-pair cross as a ring of B3 hops): the O(L^2) pair
              grid divides by the shard count.

`choose_schedule` prices each candidate's per-shard residency from shapes
alone and picks the cheapest-communication schedule that fits the budget
(`ServingConfig.sp_hbm_gb`): dense < sp_msa < sp_seq. Per-bucket overrides
(`ServingConfig.sp_schedules`) win over the heuristic and raise when
infeasible. Every byte count equals the JAX package's `jax.eval_shape`
pricing: the weight tree (int8-priced under the quantized arm; the port
prices the tree `alphafold2_init` makes on the "meta" device, which
allocates nothing), the two residual streams at LIVE_COPIES live copies,
and the f32 distogram logits. A planning estimate, not an allocator.

`build_sp_mesh(shards, devices=None)` follows `parallel/mesh.py
make_mesh`: by default `shards` distinct cards, raising on fewer; an
explicit list may repeat a device (`["cuda:0"] * 4` on one card,
`["cpu"] * 4` on the CPU). `check_mesh_placement` is the engine's rule
for a mesh: every shard on the engine's device. A CUDA graph captures one
card's stream, and the SP trunk's per-device streams over distinct cards
are ROADMAP A13's, so a mesh over distinct cards is refused naming it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

#: schedule names, in preference order (cheapest communication first):
#: `choose_schedule` picks the first feasible one that fits the budget
SP_SCHEDULES = ("dense", "sp_msa", "sp_seq")

#: live copies of each residual stream priced a trunk position (the stream,
#: its pre-norm copy, the block output, one workspace tile): the JAX
#: package's planning multiplier
LIVE_COPIES = 4


@dataclasses.dataclass(frozen=True)
class ScheduleResidency:
    """Per-shard priced residency of one (bucket, schedule) executable."""

    schedule: str
    weight_bytes: int
    pair_bytes: int      # pair residual stream x LIVE_COPIES, per shard
    msa_bytes: int       # MSA residual stream x LIVE_COPIES, per shard
    logits_bytes: int    # distogram head output (replicated; conservative)
    feasible: bool       # divisibility constraints hold for this shape

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.pair_bytes + self.msa_bytes + self.logits_bytes

    def as_dict(self) -> dict:
        return {
            "schedule": self.schedule,
            "weight_bytes": int(self.weight_bytes),
            "pair_bytes": int(self.pair_bytes),
            "msa_bytes": int(self.msa_bytes),
            "logits_bytes": int(self.logits_bytes),
            "total_bytes": int(self.total_bytes),
            "feasible": bool(self.feasible),
        }


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@functools.lru_cache(maxsize=32)
def weight_residency_bytes(model_cfg) -> int:
    """Resident weight bytes of `model_cfg`'s tree: the f32 master, or for
    weight_dtype="int8" the per-channel int8 tree `serving/quant_residency.py`
    serves (int8 values plus f32 scales in place of each quantized weight).
    Priced on the tree made on the "meta" device: shapes only."""
    from alphafold2_tpu_torch.models.alphafold2 import alphafold2_init
    from alphafold2_tpu_torch.ops.quant import quantized_path_bytes, tree_weight_bytes

    f32_cfg = (dataclasses.replace(model_cfg, weight_dtype="f32")
               if model_cfg.weight_dtype != "f32" else model_cfg)
    tree = alphafold2_init(f32_cfg, torch.Generator().manual_seed(0), "meta")
    total = tree_weight_bytes(tree)
    if model_cfg.weight_dtype == "int8":
        before, after = quantized_path_bytes(tree)
        total += after - before
    return int(total)


def _feasible(schedule: str, bucket: int, msa_rows: int, shards: int) -> bool:
    if schedule == "dense":
        return True
    if schedule == "sp_seq":
        # pair rows divide; MSA rows too when an MSA stream is served
        return bucket % shards == 0 and (msa_rows == 0 or msa_rows % shards == 0)
    if schedule == "sp_msa":
        # needs an MSA to shard; rows divide, and cols (= bucket) divide for
        # the along-rows transpose pass (msa_sharded_trunk_apply)
        return msa_rows > 0 and msa_rows % shards == 0 and bucket % shards == 0
    raise ValueError(f"unknown SP schedule {schedule!r}; known: {SP_SCHEDULES}")


def schedule_residency(model_cfg, *, bucket: int, batch: int, msa_rows: int, schedule: str,
                       shards: int, weight_bytes: Optional[int] = None) -> ScheduleResidency:
    """Price one (bucket, schedule) executable's per-shard residency from
    its shapes. `weight_bytes` (the served tree's) can be passed in so a
    ladder-wide pass prices the tree once; dense is `schedule="dense",
    shards=1`."""
    if schedule not in SP_SCHEDULES:
        raise ValueError(f"unknown SP schedule {schedule!r}; known: {SP_SCHEDULES}")
    s_pair = shards if schedule == "sp_seq" else 1
    s_msa = shards if schedule in ("sp_seq", "sp_msa") else 1
    item = _itemsize(model_cfg.dtype)
    pair = batch * max(1, bucket // s_pair) * bucket * model_cfg.dim * item
    msa = batch * max(1, msa_rows // s_msa) * bucket * model_cfg.dim * item if msa_rows else 0
    logits = batch * bucket * bucket * model_cfg.num_buckets * 4
    if weight_bytes is None:
        weight_bytes = weight_residency_bytes(model_cfg)
    return ScheduleResidency(
        schedule=schedule, weight_bytes=int(weight_bytes), pair_bytes=pair * LIVE_COPIES,
        msa_bytes=msa * LIVE_COPIES, logits_bytes=logits,
        feasible=_feasible(schedule, bucket, msa_rows, shards))


def choose_schedule(model_cfg, *, bucket: int, batch: int, msa_rows: int, shards: int,
                    hbm_bytes: float, weight_bytes: Optional[int] = None) -> ScheduleResidency:
    """The length/HBM heuristic: the cheapest-communication schedule that
    fits. Candidates run in `SP_SCHEDULES` order; infeasible cuts are
    skipped. If nothing fits, the most-sharded feasible candidate is
    returned (over budget: the engine reports it in `stats()["sp"]` rather
    than refusing to serve)."""
    if weight_bytes is None:
        weight_bytes = weight_residency_bytes(model_cfg)
    best = None
    for schedule in SP_SCHEDULES:
        res = schedule_residency(model_cfg, bucket=bucket, batch=batch, msa_rows=msa_rows,
                                 schedule=schedule, shards=shards, weight_bytes=weight_bytes)
        if not res.feasible:
            continue
        if res.total_bytes <= hbm_bytes:
            return res
        best = res  # later candidates shard more: keep the last feasible
    # "dense" is always feasible: the worst case is an over-budget plan
    assert best is not None
    return best


def plan_bucket_schedules(model_cfg, *, buckets: Tuple[int, ...], batch: int, msa_rows: int,
                          shards: int, hbm_bytes: float,
                          overrides: Optional[Mapping[int, str]] = None
                          ) -> Dict[int, ScheduleResidency]:
    """bucket -> priced schedule for the whole ladder (engine build time).
    `overrides` (`ServingConfig.sp_schedules`) win over the heuristic; one
    naming a bucket off the ladder or an infeasible cut raises."""
    overrides = dict(overrides or {})
    unknown = set(overrides) - set(buckets)
    if unknown:
        raise ValueError(f"sp_schedules overrides name bucket(s) {sorted(unknown)} not on "
                         f"the ladder {tuple(buckets)}")
    weight_bytes = weight_residency_bytes(model_cfg)
    plan: Dict[int, ScheduleResidency] = {}
    for bucket in buckets:
        forced = overrides.get(bucket)
        if forced is not None:
            res = schedule_residency(model_cfg, bucket=bucket, batch=batch, msa_rows=msa_rows,
                                     schedule=forced, shards=shards, weight_bytes=weight_bytes)
            if not res.feasible:
                raise ValueError(
                    f"sp_schedules forces {forced!r} for bucket {bucket}, but that cut is "
                    f"infeasible at msa_rows={msa_rows}, shards={shards} (divisibility)")
            plan[bucket] = res
        else:
            plan[bucket] = choose_schedule(model_cfg, bucket=bucket, batch=batch,
                                           msa_rows=msa_rows, shards=shards,
                                           hbm_bytes=hbm_bytes, weight_bytes=weight_bytes)
    return plan


def build_sp_mesh(shards: int, devices: Optional[Sequence] = None):
    """The serving mesh: `shards` shards on one axis. `devices` None takes
    the first `shards` distinct CUDA cards and raises with sizing advice on
    a host with fewer (as the JAX package raises on fewer devices); an
    explicit list may repeat a device, its first `shards` entries used."""
    from alphafold2_tpu_torch.parallel.mesh import make_mesh

    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < shards:
            raise ValueError(
                f"sp_shards={shards} needs {shards} devices, host exposes {n} — size "
                f"sp_shards to the card count, or pass the devices to place several "
                f"shards on one ({['cuda:0'] * min(shards, 2)}..., or ['cpu'] * {shards})")
    return make_mesh({"sp": shards}, devices=devices)


def check_mesh_placement(devices: Sequence, device) -> None:
    """Raise unless every shard device is the engine's `device`: a mesh
    over distinct cards names ROADMAP A13 (a CUDA graph captures one card's
    stream; the SP trunk's per-device streams are A13's), a mesh on another
    device than the engine's is a ValueError."""
    device = torch.device(device)
    placed = [torch.device(d) for d in devices]
    distinct = sorted({str(d) for d in placed})
    cards = {str(d) for d in placed if d.type == "cuda"}
    if len(cards) > 1:
        raise NotImplementedError(
            f"an SP mesh over distinct cards {distinct} is not served: a CUDA graph captures "
            f"one card's stream, and the SP trunk's per-device streams are ROADMAP A13; place "
            f"every shard on the engine's card (sp_devices=['{device}'] * {len(placed)})")
    if any(d != device for d in placed):
        raise ValueError(f"the SP mesh's shards lie on {distinct} but the engine serves on "
                         f"{device}; place every shard there")


def make_sp_apply_fn(mesh, schedule: str):
    """The forward override for `serving/pipeline.py predict_structure` and
    the engine's executables that runs `schedule` over `mesh`
    (`parallel/sp_trunk.py alphafold2_apply_sp`); None for "dense" (the
    replicated apply). The JAX function's `axis_name` is the mesh's own
    here, and its `overlap` (the double-buffered ring) is A13's."""
    if schedule == "dense":
        return None
    if schedule not in SP_SCHEDULES:
        raise ValueError(f"unknown SP schedule {schedule!r}; known: {SP_SCHEDULES}")
    from alphafold2_tpu_torch.parallel.sp_trunk import alphafold2_apply_sp

    def apply_fn(params, cfg, tokens, msa, *, mask=None, msa_mask=None, embedds=None,
                 templates=None, templates_mask=None):
        if embedds is not None:
            raise ValueError("the SP serving arm shards token/MSA row axes; the embedds "
                             "substitute stream has none — serve embedds dense")
        return alphafold2_apply_sp(params, cfg, tokens, msa, mesh, mask=mask,
                                   msa_mask=msa_mask, templates=templates,
                                   templates_mask=templates_mask, schedule=schedule)

    return apply_fn
