"""Compact wire format: batches at the information width of their ids.

Port of `two_tower_recommender_model_tpu/data/compact.py`: the scheme and
the host encode are numpy, copied; the decode is torch, on the batch's
device.

`PackedBatch` ships raw int32 ids (4 B a slot) because the hash runs on the
device. The hash is pure and the mask depends only on `raw != 0`, so the
host can hash first and ship each slot at its information width instead:

    enc(raw) = 0                         if raw == 0   (missing sentinel)
               (raw % N) + 1             otherwise     (in [1, N])

which needs ceil(log2(N+1)) bits (+1 for the label bit on slot 0 when
`pack_label`). The layout is byte-planed: each slot ships bits//8 whole
planes of `[B]` uint8, and the remaining bits%8 bits of every slot are
concatenated per example (R bits) and packed 8 examples -> R bytes in a
separate `rem[R, B//8]` buffer. The flagship two-feature model (206,209
users + label bit = 19 bits, 49,688 items = 16 bits) drops from 8 B to
4.375 B an example; with the user slot host-sorted and delta-encoded
(`delta_feature`) to 3.125 B. Bit packing needs B % 8 == 0 and 8*R <= 32;
the scheme falls back to whole-byte slots otherwise.

The decode (`batch_from_compact`) is shifts, ors, a cumsum and a scatter-add
in torch on the device, with no host synchronisation, so it runs inside a
captured CUDA graph; it gives exactly what `unpack_batch(PackedBatch)` gives:
the same hashed ids, the same `raw != 0` mask, the same labels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.data.device_featurizer import PackedBatch
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch, SparseFeature


@dataclasses.dataclass
class CompactBatch:
    """Wire-minimal batch: numpy arrays on the host, tensors on the device.
    `wire` holds the whole-byte planes; `rem` the packed remainder bits (8
    examples a byte column), None when every slot's width is a byte multiple.
    `delta_pos`/`delta_extra` carry the rare oversized deltas of a
    delta-encoded sorted slot (see `CompactScheme`)."""

    wire: Any  # [W8, B] uint8 whole-byte planes
    rem: Any  # [R, B//8] uint8 remainder-bit planes (or None)
    labels: Any  # [B] int32, or [0] when the label bit rides in the wire
    dense: Any = None
    weights: Any = None
    delta_pos: Any = None  # [K] int32 positions of deltas > 255
    delta_extra: Any = None  # [K] int32 (delta - 255) at those positions

    @property
    def batch_size(self) -> int:
        return self.wire.shape[-1]


@dataclasses.dataclass(frozen=True)
class _SlotPlan:
    feature: str
    sub: int  # sub-slot index within the feature (multi-hot features)
    slot_off: int  # column in PackedBatch.ids_raw
    num_embeddings: int
    bits: int  # total bits incl. label bit when has_label
    bits_id: int  # bits of the id payload (excl. label bit)
    has_label: bool
    byte_start: int  # first whole-byte plane in `wire`
    nbytes: int  # whole-byte planes
    rem_bits: int  # remainder bits in the shared `rem` planes
    rem_off: int  # bit offset of this slot's remainder within the R-bit group
    delta: bool = False  # sorted-slot delta encoding (one uint8 plane)


def _bits_for(n_values: int) -> int:
    return max(1, int(n_values - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class CompactScheme:
    """The static wire layout of a model config. Its field names and order are
    the reference's: a wire cache's fingerprint is `dataclasses.asdict` of it,
    so a cache either package builds is read by the other."""

    slots: tuple[_SlotPlan, ...]
    pack_label: bool
    whole_bytes: int  # W8
    rem_bits_total: int  # R (remainder bits per example; 0 = no rem buffer)
    delta_feature: str | None = None  # host-sorted slot shipped as uint8 deltas
    delta_capacity: int = 0  # K: static exception-array length (PER SEGMENT)
    # independently sorted contiguous batch segments (1 = one host-sorted
    # stream); the decode's cumsum resets at segment boundaries
    delta_segments: int = 1

    @classmethod
    def from_model(cls, model_cfg: ModelConfig, pack_label: bool = True,
                   bit_pack: bool = True, delta_feature: str | None = None,
                   delta_segments: int = 1) -> "CompactScheme":
        """`bit_pack=False` rounds every slot up to whole bytes (no remainder
        buffer), for callers that cannot guarantee B % 8 == 0.

        `delta_feature` names a single-slot feature whose batches arrive
        host-sorted by its hashed id, missing last (the `sort_feature`
        contract): that slot ships as one uint8 plane of consecutive-id
        deltas plus a fixed [K] exception sidecar for deltas > 255. The
        deltas of a sorted sequence sum to <= N+1, so at most (N+1)//256
        exceptions exist and K is a static guarantee.

        `delta_segments=H` declares the batch as H separately sorted slices
        (positions in the sidecar are segment-relative); K is then rounded
        up to a multiple of 64."""
        plans: list[_SlotPlan] = []
        byte_cursor = 0
        rem_cursor = 0
        slot_off = 0
        delta_cap = 0
        for fc in model_cfg.features:
            n = model_cfg.feature_table(fc.name).num_embeddings
            is_delta = delta_feature is not None and fc.name == delta_feature
            if is_delta and fc.max_ids_per_sample != 1:
                raise ValueError(f"delta_feature {delta_feature!r} must be single-slot")
            for sub in range(fc.max_ids_per_sample):
                has_label = pack_label and slot_off == 0
                bits_id = _bits_for(n + 1)  # enc values 0..N inclusive
                if is_delta:
                    # one uint8 delta plane; the label bit (if any) moves to the
                    # remainder group as a bit of its own
                    rem = (1 if has_label else 0) if bit_pack else 0
                    nbytes = 1 if bit_pack or not has_label else 2
                    delta_cap = (n + 1) // 256 + 2
                    if delta_segments > 1:
                        delta_cap = -(-delta_cap // 64) * 64
                    plans.append(_SlotPlan(
                        feature=fc.name, sub=sub, slot_off=slot_off, num_embeddings=n,
                        bits=8 + (1 if has_label else 0), bits_id=bits_id,
                        has_label=has_label, byte_start=byte_cursor, nbytes=nbytes,
                        rem_bits=rem, rem_off=rem_cursor, delta=True))
                    byte_cursor += nbytes
                    rem_cursor += rem
                    slot_off += 1
                    continue
                bits = bits_id + (1 if has_label else 0)
                if bits > 31:
                    raise ValueError(f"compact: slot {fc.name}[{sub}] needs {bits} bits > 31; "
                                     "use the packed wire format for this model")
                rem = bits % 8 if bit_pack else 0
                nbytes = bits // 8 if bit_pack else (bits + 7) // 8
                plans.append(_SlotPlan(
                    feature=fc.name, sub=sub, slot_off=slot_off, num_embeddings=n, bits=bits,
                    bits_id=bits_id, has_label=has_label, byte_start=byte_cursor,
                    nbytes=nbytes, rem_bits=rem, rem_off=rem_cursor))
                byte_cursor += nbytes
                rem_cursor += rem
                slot_off += 1
        if delta_feature is not None and not any(sp.delta for sp in plans):
            raise ValueError(f"delta_feature {delta_feature!r}: no such feature")
        if rem_cursor and 8 * rem_cursor > 32:
            # the remainder group of 8 examples must fit an int32: whole bytes instead
            return cls.from_model(model_cfg, pack_label, bit_pack=False,
                                  delta_feature=delta_feature, delta_segments=delta_segments)
        return cls(slots=tuple(plans), pack_label=pack_label, whole_bytes=byte_cursor,
                   rem_bits_total=rem_cursor, delta_feature=delta_feature,
                   delta_capacity=delta_cap, delta_segments=delta_segments)

    @property
    def wire_bytes_per_example(self) -> float:
        """Wire bytes an example, without the fixed [K] exception sidecar of a
        delta slot (8*K bytes a batch)."""
        return self.whole_bytes + self.rem_bits_total / 8.0


def _pack_rem(rem_group: np.ndarray, r: np.ndarray, b: int, total: int, off: int) -> None:
    """OR `r` ([B] values of a slot's remainder bits) into the [B//8]
    remainder groups: example e's bits at e % 8 * total + off."""
    lanes = r.reshape(b // 8, 8)
    shifts = np.arange(8, dtype=np.int64) * total + off
    rem_group |= (lanes << shifts[None, :]).sum(axis=1, dtype=np.int64)


def compact_from_packed(pb: PackedBatch, scheme: CompactScheme) -> CompactBatch:
    """Host half: `PackedBatch` -> `CompactBatch` (numpy; keeps the row order,
    so a `sort_feature`-sorted batch stays sorted)."""
    ids = np.asarray(pb.ids_raw)
    b = ids.shape[0]
    if scheme.rem_bits_total and b % 8:
        raise ValueError(f"compact bit-packing needs batch size % 8 == 0, got {b}")
    wire = np.empty((scheme.whole_bytes, b), np.uint8)
    rem_group = np.zeros((b // 8,), np.int64) if scheme.rem_bits_total else None
    delta_pos = delta_extra = None
    for sp in scheme.slots:
        raw = ids[:, sp.slot_off].astype(np.int64)
        label = None
        if sp.has_label:
            label = (raw >> 30) & 1
            raw = raw & ((1 << 30) - 1)
        v = (raw % sp.num_embeddings) + 1
        v = np.where(raw == 0, 0, v)
        if sp.delta:
            n = sp.num_embeddings
            k = np.where(v == 0, n + 1, v)  # missing sorts and encodes above all ids
            d = np.diff(k, prepend=0)
            if d.min() < 0:
                raise ValueError(
                    f"delta slot {sp.feature!r}: batch is not sorted by its hashed id "
                    f"(missing last): featurize with sort_feature={sp.feature!r}")
            lo = np.minimum(d, 255)
            exc = np.nonzero(d > 255)[0]
            kcap = scheme.delta_capacity
            assert len(exc) <= kcap, (len(exc), kcap)  # sum(d) <= N+1 bounds the count
            delta_pos = np.zeros(kcap, np.int32)
            delta_extra = np.zeros(kcap, np.int32)
            delta_pos[: len(exc)] = exc
            delta_extra[: len(exc)] = (d[exc] - 255).astype(np.int32)
            wire[sp.byte_start] = lo.astype(np.uint8)
            if sp.has_label:
                if sp.rem_bits:  # the label bit rides the remainder group
                    _pack_rem(rem_group, label, b, scheme.rem_bits_total, sp.rem_off)
                else:  # whole-byte fallback: the label in its own plane
                    wire[sp.byte_start + 1] = label.astype(np.uint8)
            continue
        if label is not None:
            v = v | (label << sp.bits_id)
        for j in range(sp.nbytes):
            wire[sp.byte_start + j] = (v >> (8 * j)).astype(np.uint8)
        if sp.rem_bits:
            r = (v >> (8 * sp.nbytes)) & ((1 << sp.rem_bits) - 1)
            _pack_rem(rem_group, r, b, scheme.rem_bits_total, sp.rem_off)
    rem = None
    if rem_group is not None:
        rem = np.empty((scheme.rem_bits_total, b // 8), np.uint8)
        for j in range(scheme.rem_bits_total):
            rem[j] = (rem_group >> (8 * j)).astype(np.uint8)
    return CompactBatch(wire=wire, rem=rem, labels=np.asarray(pb.labels), dense=pb.dense,
                        weights=pb.weights, delta_pos=delta_pos, delta_extra=delta_extra)


def _add_exceptions(d: torch.Tensor, pos: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """`d[pos] += extra`, dropping positions outside [0, B) as the reference's
    scatter with `mode="drop"` does: each is clamped into range and its extra
    zeroed, so nothing asks the host and nothing asserts on the device."""
    b = d.shape[0]
    live = (pos >= 0) & (pos < b)
    return d.index_add_(0, pos.clamp(0, b - 1).long(),
                        torch.where(live, extra, torch.zeros_like(extra)))


def batch_from_compact(cb: CompactBatch, model_cfg: ModelConfig,
                       scheme: CompactScheme, part: tuple | None = None) -> Batch:
    """Device half: byte planes -> hashed ids + masks + labels, on the
    planes' device, without a host synchronisation (it runs inside a captured
    CUDA graph). Equal to `unpack_batch(PackedBatch)` on the same data.

    `part=(i, n, prefix)` decodes slice i of n equal slices of a batch (a
    data-parallel rank's: planes, rem groups, labels, dense and weights cut
    on the batch axis, the delta sidecars whole): the delta slot takes the
    sidecar's exceptions that fall in the slice, and `prefix(total)` gives
    the exclusive prefix of the slice's deltas within its sorted segment (the
    sums of the slices before it; `parallel.sharded.delta_prefix`), so each
    row decodes to the whole batch's value bit for bit."""
    del model_cfg  # the reference's signature; the scheme carries the layout
    wire = cb.wire
    labels = cb.labels
    b = wire.shape[-1]
    dev = wire.device

    def planes(buf, start: int, count: int) -> torch.Tensor:
        """Byte planes buf[start:start+count] as one int32, little end first."""
        v = buf[start].to(torch.int32)
        for j in range(1, count):
            v = v | (buf[start + j].to(torch.int32) << (8 * j))
        return v

    rem_val = rem_lane = None
    if scheme.rem_bits_total:
        g = planes(cb.rem, 0, scheme.rem_bits_total)
        rem_val = g[:, None].expand(-1, 8).reshape(-1)  # [B]: each group on its 8 lanes
        rem_lane = torch.arange(b, dtype=torch.int32, device=dev) % 8

    per_feature_ids: dict[str, list] = {}
    per_feature_mask: dict[str, list] = {}
    for sp in scheme.slots:
        if sp.delta:
            d = wire[sp.byte_start].to(torch.int32)
            s = scheme.delta_segments
            if part is not None:
                i, n, prefix = part
                kcap = scheme.delta_capacity
                held = cb.delta_pos.shape[-1] // kcap  # segments in the sliced batch
                seg = b * n // held
                pos = (cb.delta_pos.reshape(held, kcap)
                       + torch.arange(held, dtype=torch.int32, device=dev)[:, None] * seg)
                # exceptions outside the slice (and the padding entries) drop out
                d = _add_exceptions(d, pos.reshape(-1) - i * b, cb.delta_extra.reshape(-1))
                k = torch.cumsum(d, dim=0, dtype=torch.int32)
                k = k + prefix(k[-1])
            elif s > 1:
                # separately sorted slices: sidecar positions are segment-relative
                # ([S*K]) and the cumsum resets at each segment's start
                seg = b // s
                kcap = scheme.delta_capacity
                pos = (cb.delta_pos.reshape(s, kcap)
                       + torch.arange(s, dtype=torch.int32, device=dev)[:, None] * seg)
                # padding entries carry extra 0 at each segment's base: += 0
                d = _add_exceptions(d, pos.reshape(-1), cb.delta_extra)
                k = torch.cumsum(d.reshape(s, seg), dim=1, dtype=torch.int32).reshape(b)
            else:
                d = _add_exceptions(d, cb.delta_pos, cb.delta_extra)
                k = torch.cumsum(d, dim=0, dtype=torch.int32)
            n = sp.num_embeddings
            v = torch.where(k == n + 1, 0, k)
            if sp.has_label:
                if sp.rem_bits:
                    labels = (rem_val >> (rem_lane * scheme.rem_bits_total + sp.rem_off)) & 1
                else:
                    labels = wire[sp.byte_start + 1].to(torch.int32) & 1
        else:
            v = (planes(wire, sp.byte_start, sp.nbytes) if sp.nbytes
                 else torch.zeros((b,), dtype=torch.int32, device=dev))
            if sp.rem_bits:
                r = (rem_val >> (rem_lane * scheme.rem_bits_total + sp.rem_off)) & (
                    (1 << sp.rem_bits) - 1)
                v = v | (r << (8 * sp.nbytes))
            if sp.has_label:
                labels = (v >> sp.bits_id) & 1
                v = v & ((1 << sp.bits_id) - 1)
        per_feature_ids.setdefault(sp.feature, []).append(torch.clamp_min(v - 1, 0))
        per_feature_mask.setdefault(sp.feature, []).append(v != 0)

    def columns(cols: list) -> torch.Tensor:  # [B, L]; one slot is a view, not a copy
        return cols[0].unsqueeze(1) if len(cols) == 1 else torch.stack(cols, dim=1)

    feats = {
        name: SparseFeature(ids=columns(cols).to(torch.int32),
                            mask=columns(per_feature_mask[name]).to(torch.float32))
        for name, cols in per_feature_ids.items()
    }
    return Batch(features=feats, labels=labels.to(torch.int32), dense=cb.dense,
                 weights=cb.weights)


class CompactFeaturizer:
    """Host featurizer adapter: wraps any featurizer that yields a
    `PackedBatch` (`PackedFeaturizer`, `PrepackedFeaturizer`) and re-encodes
    it to the compact wire. Row sorting (`sort_feature`) happens in the inner
    featurizer, before encoding."""

    def __init__(self, inner, scheme: CompactScheme):
        inner_pl = getattr(inner, "pack_label", None)
        if inner_pl is not None and inner_pl != scheme.pack_label:
            # a mismatch corrupts data silently: pack_label=False on a label-packed
            # inner hashes raw|1<<30 values; the reverse misreads bit 30 of legal ids
            raise ValueError(f"CompactScheme.pack_label={scheme.pack_label} does not match "
                             f"the inner featurizer's pack_label={inner_pl}")
        if scheme.delta_feature is not None:
            inner_sort = getattr(inner, "sort_feature", None)
            if inner_sort != scheme.delta_feature:
                raise ValueError(f"delta_feature {scheme.delta_feature!r} requires the inner "
                                 f"featurizer to sort by it (sort_feature={inner_sort!r})")
        self.inner = inner
        self.scheme = scheme

    def __call__(self, columns: Mapping[str, np.ndarray]) -> CompactBatch:
        return compact_from_packed(self.inner(columns), self.scheme)


def make_compact_train_step(train_step, model_cfg: ModelConfig, scheme: CompactScheme):
    """Wrap a (state, Batch) train step to take a `CompactBatch`."""

    @functools.wraps(train_step)
    def step(state, cb: CompactBatch):
        return train_step(state, batch_from_compact(cb, model_cfg, scheme))

    return step


def make_compact_eval_step(eval_step, model_cfg: ModelConfig, scheme: CompactScheme):
    """Wrap a (state, eval_state, Batch) eval step to take a `CompactBatch`."""

    @functools.wraps(eval_step)
    def step(state, eval_state, cb: CompactBatch):
        return eval_step(state, eval_state, batch_from_compact(cb, model_cfg, scheme))

    return step
