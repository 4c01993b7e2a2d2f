"""Serial execution backend: the single-device fused superstep pipeline,
port of ``repro.core.runtime.serial``.

The sealed frontier re-materialises in device-budget waves (one wave
without a budget), each wave is uploaded once and sliced into pow2-padded
chunks on the device, a *pilot* chunk calibrates the step's
output-capacity bucket, the remaining chunks dispatch back-to-back with
counts left on the device, and the host drains all control values in
stacked window reads — at most TWO host syncs per superstep and wave
(``async_chunks=True``). The chunk loop with
one blocking count read per chunk is kept bit for bit as
``async_chunks=False``.

Pattern aggregation is device-resident by default (DESIGN.md §10): chunk
programs emit pre-binned level-1 *partials* that fold across the
stacked-drain window (:class:`repro_torch.core.aggregation.DeviceLevel1`),
or — when FSM needs the local-vertex table for its min-image domains — the
waves are re-binned on the device at aggregation time. Either way only
O(Q) bytes (distinct codes, counts, the canonical domain bitmaps, and an
alpha row mask iff pruning fires) cross to the host;
``device_aggregate=False`` keeps the host reference path
(``aggregation.aggregate_rows``). Level 2 runs where
``canonical_placement`` puts it (DESIGN.md §15): on the host, on a
background thread joined at the next seal (``host_async``), or on the
device through the canonical-refine kernel (``device``).

The bound graph is a ``DeviceGraph`` or a ``PartitionedGraph``; with the
latter every chunk program opens with the halo-tile gather
(``explore.build_tile_view``). Under ``trace_sync`` a standalone gather
probe per chunk times that stage into ``StepStats.t_gather``
(``obs.probe_time``); otherwise it rides ``t_expand`` and ``t_gather``
stays 0.0.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, explore, obs, pattern as pattern_lib
from repro_torch.core.api import MiningApp
from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.runtime import faults as faults_lib
from repro_torch.core.runtime import programs
from repro_torch.core.runtime.backend import ExecutionBackend
from repro_torch.core.runtime.config import next_pow2
from repro_torch.core.store import FrontierStore, make_store
from repro_torch.kernels import canonical_refine

#: chunk programs in flight between drains: bounds how many capacity-
#: padded output buffers are device-resident at once while keeping host
#: syncs at O(chunks / window) per superstep.
_DRAIN_WINDOW = 32


class SerialBackend(ExecutionBackend):
    name = "serial"

    def _make_store(self) -> FrontierStore:
        config, app = self.config, self.app
        self._device = self.g.device
        self._use_pallas = bool(config.use_pallas)
        self._agg_kernel = bool(config.aggregate_kernel)
        self._agg_bin = config.resolve_aggregate_bin()
        store = make_store(
            config.store, self.g,
            mode=app.mode,
            app_filter=programs.store_app_filter(app, self.g),
            use_pallas=self._use_pallas,
            device_budget_bytes=config.device_budget_bytes,
        )
        # device-resident aggregation needs alpha at pattern granularity:
        # apps overriding the per-row aggregation_filter keep the host path
        self._device_agg = (
            config.device_aggregate
            and app.wants_patterns
            and type(app).aggregation_filter is MiningApp.aggregation_filter
        )
        # level-2 placement (DESIGN.md §15): host_async needs a deferrable
        # table (the loop joins it at the seal) — pruning and domain apps
        # run the synchronous host placement, bit-identical either way
        self._canon_placement = config.resolve_canonical_placement()
        if self._canon_placement == "host_async" and not (
            self._device_agg and aggregation.async_level2_ok(app)
        ):
            self._canon_placement = "host"
        if config.canonical_memo_cap is not None:
            pattern_lib.set_memo_cap(config.canonical_memo_cap)
        #: cross-batch level-1 merge capacity, grown pow2 on observed
        #: overflow (the unclamped distinct count rides the one drain)
        self._agg_qcap = max(config.agg_qcap, 1)
        self._run_qcap = next_pow2(self._agg_qcap)
        # child codes / level-1 partials computed in the chunk program are
        # only reusable when the next superstep re-materialises exactly the
        # appended rows in order — true for the raw store (also under a
        # spill budget), not for ODAG extraction (which may resurrect
        # pattern-pruned rows)
        order_preserving = (
            config.async_chunks and app.wants_patterns and store.kind == "raw"
        )
        self.with_patterns = order_preserving and not self._device_agg
        # FSM (wants_domains) re-bins at wave time instead: the domain
        # scatter needs the per-row local-vertex table, which partials drop
        self.with_aggregates = (
            order_preserving and self._device_agg and not app.wants_domains
        )
        self._expand_fn = self._make_expand_fn()
        self._signatures = set()
        self._lvl1 = None
        self._table = None
        return store

    def _gather_probe(self, members, n_valid):
        """The tile-gather stage alone, for ``StepStats.t_gather``
        (DESIGN.md §12): ``build_tile_view`` runs INSIDE the chunk program,
        so its share of ``t_expand`` is only separable by a probe, paid
        only under ``trace_sync=True`` (the diagnostic mode)."""
        return explore.build_tile_view(
            self.g, members, n_valid, self.app.mode,
            use_pallas=self._use_pallas,
            compact_kernel=bool(self.config.compact_kernel),
        ).nbr_t

    def _make_expand_fn(self):
        config, app = self.config, self.app
        return programs.make_expand_fn(
            app, app.mode,
            use_pallas=self._use_pallas,
            fused=config.fused_expand,
            compact_kernel=bool(config.compact_kernel),
            with_patterns=self.with_patterns,
            with_aggregates=self.with_aggregates,
            agg_qcap=self._agg_qcap,
            aggregate_kernel=self._agg_kernel,
            aggregate_bin=self._agg_bin,
            with_local_verts=app.wants_domains,
        )

    def _new_level1(self) -> aggregation.DeviceLevel1:
        return aggregation.DeviceLevel1(
            merge_cap=self._run_qcap,
            use_kernel=self._agg_kernel,
            bin_method=self._agg_bin,
        )

    # -- superstep hooks ----------------------------------------------------
    def begin_step(self, store, st) -> List[np.ndarray]:
        self._waves = list(store.chunks())
        self._wave_dev: List[Optional[torch.Tensor]] = [None] * len(self._waves)
        return self._waves

    def quick_codes(self, blocks, size):
        codes_parts, lv_parts = [], []
        for wi, w in enumerate(blocks):
            self._wave_dev[wi] = programs.upload(w, self._device)
            qp = programs.quick_patterns(
                self.g, self.app.mode, self._wave_dev[wi],
                torch.full((len(w),), size, dtype=torch.int32,
                           device=self._device),
            )
            codes_parts.append(qp.codes.cpu().numpy())
            lv_parts.append(qp.local_verts.cpu().numpy())
            if self.config.device_budget_bytes is not None:
                # SpillStore contract: one budget wave resident at a time —
                # expansion re-uploads its own wave
                programs.retire(self._wave_dev, [wi])
        codes = (
            np.concatenate(codes_parts)
            if codes_parts else np.zeros((0, 3), np.int64)
        )
        lv = (
            np.concatenate(lv_parts)
            if lv_parts
            else np.zeros((0, pattern_lib.MAX_PATTERN_VERTICES), np.int32)
        )
        return codes, lv

    def aggregate(self, codes, lv, st):
        # host-resident level 1 (reference path): placement "device" still
        # routes the miss batch through the refine kernel
        canon_fn = (
            canonical_refine.make_canon_fn(
                use_kernel=self._agg_kernel, device=self._device
            )
            if self._canon_placement == "device"
            else None
        )
        agg, canon_slot = aggregation.aggregate_rows(
            self.g.n, codes, lv, self.app.wants_domains, canon_fn=canon_fn
        )
        obs.set_stat(st, "n_quick_patterns", agg.n_quick)
        obs.set_stat(st, "n_canonical_patterns", agg.n_canonical)
        obs.set_stat(st, "n_iso_checks", agg.n_iso_checks)
        return agg, canon_slot

    # -- device-resident aggregation (DESIGN.md §10) ------------------------
    def aggregate_step(self, blocks, size, carried, st):
        if not self._device_agg:
            return super().aggregate_step(blocks, size, carried, st)
        app = self.app
        n_frontier = sum(len(blk) for blk in blocks)
        lvl1 = (
            carried
            if isinstance(carried, aggregation.DeviceLevel1)
            and carried.rows == n_frontier
            else None
        )
        if lvl1 is None:
            lvl1 = self._fold_waves(blocks, size)
        res = lvl1.finish()
        if res is not None and faults_lib.take(
            self.config.faults, "aggregate", st.step, "saturate"
        ):
            # injected count saturation (DESIGN.md §13): discard the packed
            # result exactly as a tripped saturation flag would, forcing
            # the wide re-fold below — same recovery path, deterministic
            res = None
        if res is None:
            # a chunk partial or eager compaction overflowed: re-fold from
            # the waves, and grow ``agg_qcap`` pow2-style from the
            # unclamped distinct count that rode the drain, so later
            # supersteps keep carrying partials
            self._run_qcap = max(
                self._run_qcap, next_pow2(max(lvl1.observed_n, 1))
            )
            self._grow_carried_partials(self._run_qcap)
            lvl1 = self._fold_waves(blocks, size)
            res = lvl1.finish()
        uniq, counts_q, nbytes = res
        self._run_qcap = max(self._run_qcap, next_pow2(max(lvl1.observed_n, 1)))
        obs.count(st, "bytes_to_host", nbytes)
        placement = self._canon_placement
        if placement == "host_async":
            # overlap: the loop joins the pending batch at the seal
            # boundary, after the next expansion has been enqueued;
            # async_level2_ok guarantees no pruning reads the table
            with obs.annotate("canonicalize_submit"):
                pending = aggregation.submit_level2(uniq, counts_q)
            self._lvl1, self._table = lvl1, None
            self._agg_blocks, self._agg_size = blocks, size
            return pending, None
        t0 = time.perf_counter()
        with obs.span("canonicalize", placement=placement, n_quick=len(uniq)):
            if placement == "device" and lvl1._final is not None and len(uniq):
                u, c, uv, fcap, _ = lvl1._final
                table, counts, nbytes2 = aggregation.device_level2(
                    u, c, uv, fcap, len(uniq), uniq, counts_q,
                    nvs=aggregation.level2_nvs(app, size),
                    with_domains=app.wants_domains,
                    use_kernel=self._agg_kernel, method=self._agg_bin,
                )
                obs.count(st, "bytes_to_host", nbytes2)
            else:
                table, counts = aggregation.finish_quick_level2(
                    uniq, counts_q, app.wants_domains
                )
        obs.count(st, "t_canon", time.perf_counter() - t0)
        if app.wants_domains and len(table.canon_codes):
            bm = self._scatter_domains(lvl1, table, st)
            supports = aggregation.min_image_support(
                bm, table.canon_n_verts, table.canon_orbits
            )
        else:
            supports = counts.copy()
        agg = aggregation.build_step_aggregates(
            table, counts, supports, len(uniq), st
        )
        self._lvl1, self._table = lvl1, table
        self._agg_blocks, self._agg_size = blocks, size
        return agg, None

    def _grow_carried_partials(self, qcap: int) -> None:
        """Swap the chunk program for one whose per-chunk level-1 partial
        is bound at the grown pow2 ``qcap``; carried partials stay on."""
        if not self.with_aggregates or qcap <= self._agg_qcap:
            return
        self._agg_qcap = qcap
        self._expand_fn = self._make_expand_fn()

    def _fold_waves(self, blocks, size) -> aggregation.DeviceLevel1:
        """Device re-bin of the materialised frontier: quick patterns per
        wave (on the upload the expansion reuses) folded into one
        :class:`DeviceLevel1`; per-wave slot ids and local-vertex tables
        stay on the device for the FSM domain scatter and alpha masks."""
        lvl1 = self._new_level1()
        wave_dev = (
            self._wave_dev
            if blocks is self._waves
            else [None] * len(blocks)
        )
        for wi, w in enumerate(blocks):
            if not len(w):
                continue
            if wave_dev[wi] is None:
                wave_dev[wi] = programs.upload(w, self._device)
            qp = programs.quick_patterns(
                self.g, self.app.mode, wave_dev[wi],
                torch.full((len(w),), size, dtype=torch.int32,
                           device=self._device),
            )
            lvl1.fold_rows(
                qp.codes,
                qp.local_verts if self.app.wants_domains else None,
            )
            del qp
            if self.config.device_budget_bytes is not None:
                programs.retire(wave_dev, [wi])
        return lvl1

    def _scatter_domains(self, lvl1, table, st) -> np.ndarray:
        """FSM phase 2: scatter every batch's vertices into one flat
        canonical domain bitmap on the device (``pc_cap * 8 * N + 1``
        bools, allocated once a step, the last slot the dump); only the
        (Pc, 8, N) result crosses, in one copy."""
        pc = len(table.canon_codes)
        pc_cap = next_pow2(max(pc, 1))
        n = self.g.n
        q2c, si = aggregation.level2_device_tables(
            table, lvl1.final_cap, self._device
        )
        kmax = pattern_lib.MAX_PATTERN_VERTICES
        flat = torch.zeros((pc_cap * kmax * n + 1,), dtype=torch.bool,
                           device=self._device)
        for i in range(len(lvl1.batches)):
            flat = aggregation.scatter_canon_bitmaps(
                flat, lvl1.batch_slots(i), lvl1.batches[i][1],
                q2c, si, pc_cap, n,
            )
        bm = flat[: pc * kmax * n].reshape(pc, kmax, n).cpu().numpy()
        obs.count(st, "bytes_to_host", bm.nbytes)
        return bm

    def alpha_rows(self, pk, st):
        """Per-row alpha from the per-pattern verdict: gather the (padded)
        per-quick-slot keep table through the device-resident slot ids and
        drain the O(B) mask once."""
        lvl1, table = self._lvl1, self._table
        if not lvl1.batches:
            # carried partials hold no per-row slots: re-bin the waves (the
            # distinct table is sorted, so slot order matches `table`)
            lvl1 = self._fold_waves(self._agg_blocks, self._agg_size)
            res = lvl1.finish()
            obs.count(st, "bytes_to_host", res[2])
            self._lvl1 = lvl1
        q = len(table.quick_codes)
        pk_q = np.zeros(lvl1.final_cap, dtype=bool)
        pk_q[:q] = np.asarray(pk, dtype=bool)[table.quick_to_canon]
        pk_dev = torch.from_numpy(pk_q).to(self._device)
        parts = [
            pk_dev[lvl1.batch_slots(i)] for i in range(len(lvl1.batches))
        ]
        if not parts:
            return np.zeros((0,), dtype=bool)
        mask = (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu().numpy()
        obs.count(st, "bytes_to_host", mask.nbytes)
        return mask

    def prune(self, blocks, alpha):
        # pruned rows invalidate the device-resident waves
        blocks = super().prune(blocks, alpha)
        self._waves = blocks
        self._wave_dev = [None] * len(blocks)
        return blocks

    def expand(self, store, blocks, size, st):
        config = self.config
        # the device-upload cache is valid only for the exact block list
        # this backend handed out (begin_step) or pruned
        wave_dev = (
            self._wave_dev
            if blocks is self._waves
            else [None] * len(blocks)
        )
        carried = None
        if config.async_chunks:
            #: the NEXT superstep's level-1 state, folded from the chunk
            #: partials as the drain windows complete (DESIGN.md §10)
            lvl1 = self._new_level1() if self.with_aggregates else None
            if config.device_budget_bytes is not None and len(blocks) > 1:
                # SpillStore contract (DESIGN.md §7): at most one budget
                # wave on the device at a time — pipeline and drain one
                # wave per pass (syncs O(frontier / budget), still
                # independent of the chunk count) and drop each wave's
                # buffers before the next is uploaded
                parts = []
                for wi in range(len(blocks)):
                    c, self.capacity = self._expand_fused(
                        store, [blocks[wi]], [wave_dev[wi]], size,
                        self.capacity, st, lvl1,
                    )
                    programs.retire(wave_dev, [wi])
                    if c is not None:
                        parts.append(c)
                if self.with_patterns:
                    carried = (
                        (
                            np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts]),
                        )
                        if parts
                        else None
                    )
                else:
                    carried = lvl1
            else:
                c, self.capacity = self._expand_fused(
                    store, blocks, wave_dev, size, self.capacity, st, lvl1
                )
                carried = lvl1 if self.with_aggregates else c
        else:
            self._expand_legacy(store, blocks, size, st)
        # every chunk has been drained — the step's device waves are dead
        programs.retire(wave_dev)
        return carried

    def end_step(self, store, st) -> None:
        # release last step's retained level-1 state and the materialised
        # block list kept for the alpha re-fold
        self._lvl1 = None
        self._table = None
        self._agg_blocks = None

    def finalize(self, stats) -> None:
        stats.chunk_signatures = sorted(self._signatures)
        stats.n_compiles = len(self._signatures)

    # -- the fused pipeline (DESIGN.md §8) ----------------------------------
    def _rec(self, out, used_cap):
        """Name one chunk program's outputs (layout differs between the
        carried-codes and carried-partials modes)."""
        if self.with_aggregates:
            children, count, u, c, n, ngen, ncanon = out
            return {"children": children, "count": count,
                    "agg": (u, c, n), "ngen": ngen, "ncanon": ncanon,
                    "used_cap": used_cap}
        children, count, codes, lv, ngen, ncanon = out
        return {"children": children, "count": count, "codes": codes,
                "lv": lv, "ngen": ngen, "ncanon": ncanon,
                "used_cap": used_cap}

    def _expand_fused(self, store, waves, wave_dev, size, cap, st, lvl1):
        """One *pilot* chunk calibrates the step's output-capacity bucket
        (sync 1); the remaining chunks dispatch back-to-back with counts
        left on the device and drain in stacked reads of ``_DRAIN_WINDOW``
        chunks (one more sync per window). Compaction counts are exact, so
        overshot chunks are re-dispatched at their exact pow2 bucket without
        any further sync. As a window drains, its children fold into the
        store via device-side prefix slices, and the next step's pattern
        state folds on the device: carried child quick codes
        (``with_patterns``) or level-1 partials into ``lvl1``
        (``with_aggregates``)."""
        g, expand_fn = self.g, self._expand_fn
        config, signatures = self.config, self._signatures
        with_patterns, with_aggregates = self.with_patterns, self.with_aggregates
        chunks = list(programs.iter_chunks(
            waves, wave_dev, config.chunk_size, size, self._device
        ))
        obs.count(st, "n_chunks", len(chunks))
        if not chunks:
            return None, cap
        if isinstance(g, PartitionedGraph) and obs.sync_active():
            for ch in chunks:
                obs.count(st, "t_gather",
                          obs.probe_time(self._gather_probe, ch[4], ch[5]))

        # ---- pilot: sync 1 calibrates the capacity bucket for the step --
        _, _, cb0, bucket0, chunk0, n_valid0 = chunks[0]
        signatures.add((size, bucket0, cap))
        with obs.annotate("fused_chunk.pilot"):
            out = self._rec(expand_fn(g, chunk0, n_valid0, out_cap=cap), cap)
        c0 = int(out["count"])
        obs.count(st, "n_host_syncs", 1)
        if c0 > cap:
            cap = next_pow2(c0)
            signatures.add((size, bucket0, cap))
            out = self._rec(                       # count known exact
                expand_fn(g, chunk0, n_valid0, out_cap=cap), cap
            )
        # scale the pilot count to a full bucket for the remaining chunks; a
        # chunk that still overshoots is re-dispatched individually below
        est = -((-c0 * bucket0) // max(cb0, 1))        # ceil(c0 * bucket0 / cb0)
        step_cap = max(next_pow2(max(est, 1)), 64)

        codes_parts, lv_parts = [], []

        def drain(pending):
            """One stacked control sync for a window of dispatched chunks,
            exact-cap overflow retries, then fold."""
            meta = torch.stack([
                s for p, _ in pending
                for s in (p["count"], p["ngen"], p["ncanon"])
            ]).cpu().numpy().reshape(-1, 3)
            obs.count(st, "n_host_syncs", 1)
            counts = meta[:, 0]
            obs.count(st, "n_generated", int(meta[:, 1].sum()))
            obs.count(st, "n_canonical", int(meta[:, 2].sum()))
            for i, (p, ch) in enumerate(pending):
                if counts[i] <= p["used_cap"]:
                    continue
                retry_cap = next_pow2(int(counts[i]))
                signatures.add((size, ch[3], retry_cap))
                p2 = self._rec(
                    expand_fn(g, ch[4], ch[5], out_cap=retry_cap), retry_cap
                )
                pending[i] = (p2, ch)
            for i, (p, ch) in enumerate(pending):
                cnt = int(counts[i])
                if cnt:
                    # device-side prefix slices: the padding never crosses
                    # to the host
                    store.append(p["children"][:cnt].cpu().numpy())
                    if with_patterns:
                        codes_parts.append(p["codes"][:cnt].cpu().numpy())
                        lv_parts.append(p["lv"][:cnt].cpu().numpy())
                    if with_aggregates and lvl1 is not None:
                        u, c, n = p["agg"]
                        acap = min(p["used_cap"], self._agg_qcap)
                        lvl1.fold_partial(
                            u, c, n, acap, cnt,
                            may_overflow=p["used_cap"] > acap,
                        )

        pending = [(out, chunks[0])]
        for ch in chunks[1:]:
            _, _, _, bucket_i, chunk_i, n_valid_i = ch
            signatures.add((size, bucket_i, step_cap))
            with obs.annotate("fused_chunk"):
                p = self._rec(
                    expand_fn(g, chunk_i, n_valid_i, out_cap=step_cap),
                    step_cap,
                )
            pending.append((p, ch))
            if len(pending) >= _DRAIN_WINDOW:
                drain(pending)
                pending = []
        if pending:
            drain(pending)
        cap = max(cap, step_cap)

        carried = None
        if with_patterns and codes_parts:
            carried = (np.concatenate(codes_parts), np.concatenate(lv_parts))
        return carried, cap

    # -- the chunk loop, kept as the measured baseline ---------------------
    def _expand_legacy(self, store, waves, size, st):
        """The chunk loop with one blocking count read per chunk, kept bit
        for bit: every chunk is sliced and padded on the host and uploaded,
        one host sync per chunk plus one per capacity retry, the capacity
        bucket reset every superstep."""
        g, expand_fn, config = self.g, self._expand_fn, self.config
        dev = self._device
        cap = max(config.initial_capacity, 1)
        for w in waves:
            for lo in range(0, len(w), config.chunk_size):
                chunk = np.asarray(w[lo: lo + config.chunk_size])
                cb = int(chunk.shape[0])
                bucket = min(config.chunk_size, next_pow2(max(cb, 1)))
                pad = bucket - cb
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.full((pad, size), -1, np.int32)], axis=0
                    )
                n_valid = torch.cat([
                    torch.full((cb,), size, dtype=torch.int32, device=dev),
                    torch.zeros((pad,), dtype=torch.int32, device=dev),
                ])
                chunk = programs.upload(chunk, dev)
                obs.count(st, "n_chunks", 1)
                while True:
                    self._signatures.add((size, bucket, cap))
                    out = expand_fn(g, chunk, n_valid, out_cap=cap)
                    children, count = out[0], out[1]
                    ngen, ncanon = out[-2], out[-1]
                    count = int(count)
                    obs.count(st, "n_host_syncs", 1)
                    if count <= cap:
                        break
                    cap = next_pow2(count)
                obs.count(st, "n_generated", int(ngen))
                obs.count(st, "n_canonical", int(ncanon))
                if count:
                    store.append(children[:count].cpu().numpy())
