"""Pluggable survey workloads for the claim→fit→checkpoint engine.

``runner/execute.py``'s loop — lease-based claiming over the union
ledger, per-archive fault isolation, checkpoint/ledger reconciliation,
obs shards, elastic resume — was built for GetTOAs but is not specific
to it.  This module factors the GetTOAs-specific shape into a
:class:`Workload` interface and registers four implementations, so
every pipeline of the paper's workflow (PAPER.md; SURVEY.md §0) runs
behind the same engine:

``toas``
    Wideband (+ narrowband) TOA measurement — the engine's original
    workload, bit-identical to the pre-workload behavior.  Checkpoint:
    the ``toas.<pid>.tim`` block+marker protocol (pipelines/toas.py).
``zap``
    Per-archive RFI excision: ``pipelines/zap.get_zap_channels``
    proposals applied in place with ``apply_zaps``.  Decisions land in
    the ledger (``n_zapped`` on the done record) where a later
    ``toas`` pass over the same workdir surfaces them as a ``pre_fit``
    stage on its claim records.
``align``
    Survey-scale iterative template building: ``pipelines/align.py``'s
    per-iteration batched fit becomes claimable per-archive accumulate
    units (each writes a weighted partial sum to
    ``align_parts/<pass>/``), with an idempotent weighted-average
    reduce per iteration that any process may perform once the pass's
    union ledger shows every archive settled.
``modelfit``
    ppgauss/ppspline model construction over averaged portraits, one
    model file per archive under ``<workdir>/models/``.

The device work of each workload (the archive loads, the toas fits, the
align block, the model fits) runs on the workload's ``device`` (None =
the CUDA device; ``"cpu"`` must be asked for); ``zap``'s proposal walk
and weight rewrite are host numpy.

Checkpoint protocol: the non-toas workloads checkpoint one JSONL line
per archive (a *complete block* — torn tails are dropped on replay,
exactly the ``.tim`` discipline), written in one locked append behind
the same ``checkpoint_flush`` chaos site as ``get_TOAs``, so the
fault matrix (testing/faults.py) behaves identically under every
workload.  Ledger records carry ``workload`` (runner/queue.py); old
ledgers without the field replay as ``toas``.
"""

# every checkpoint open/write/readline below happens under _ckpt_lock
# BY DESIGN: the per-path lock exists to serialize exactly that IO
# (atomic append / read-rewrite), mirroring pipelines/toas.py

import hashlib
import json
import os
import time

import numpy as np

from .. import obs
from ..obs import tracing
from ..testing import faults
from .queue import DEFAULT_WORKLOAD, DONE

__all__ = ["Workload", "ToasWorkload", "ZapWorkload", "AlignWorkload",
           "ModelFitWorkload", "register_workload", "get_workload",
           "workload_names", "resolve_workload",
           "read_jsonl_checkpoint", "append_jsonl_checkpoint",
           "drop_jsonl_checkpoint_blocks"]


# -- JSONL workload checkpoints ----------------------------------------
# One line per archive == one complete block.  Appends go through the
# same per-file lock as the .tim protocol (the service may run several
# fits of one tenant concurrently) and the same checkpoint_flush chaos
# site, so kill/resume and injected-fault behavior match get_TOAs'.

def _ckpt_lock(path):
    from ..pipelines.toas import _checkpoint_lock

    return _checkpoint_lock(path)


def read_jsonl_checkpoint(path):
    """{realpath(archive): record} for every complete line of a JSONL
    workload checkpoint; torn tail lines (kill mid-append) and
    unparseable lines are dropped, mirroring ``_resume_checkpoint``."""
    out = {}
    if not path or not os.path.isfile(path):
        return out
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                key = rec.get("archive") if isinstance(rec, dict) \
                    else None
                if key:
                    out[key] = rec
    except OSError:
        return {}
    return out


def append_jsonl_checkpoint(path, rec, key=None):
    """Append one archive's block in ONE locked, flushed write.

    The ``checkpoint_flush`` chaos site fires here exactly like inside
    ``get_TOAs``' block+marker append: an injected fault means nothing
    of this archive lands in the checkpoint, and the reconcile path
    refits it.  An ambient trace id is stamped on the record so
    replayed blocks stay causally auditable (cf. ``_trace_marker``)."""
    faults.check("checkpoint_flush", key=key or rec.get("archive"))
    tid = tracing.current_trace_id()
    if tid and "trace" not in rec:
        rec = dict(rec, trace=tid)
    line = json.dumps(rec, default=str) + "\n"
    with _ckpt_lock(path):
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(line)
            fh.flush()
    return rec


def drop_jsonl_checkpoint_blocks(path, archives):
    """Atomically rewrite a JSONL checkpoint without the given
    archives' blocks; returns the number dropped
    (``drop_checkpoint_blocks`` for JSONL workload checkpoints)."""
    targets = {os.path.realpath(a) for a in archives}
    if not targets or not path or not os.path.isfile(path):
        return 0
    with _ckpt_lock(path):
        with open(path, encoding="utf-8") as fh:
            lines = fh.readlines()
        kept, dropped = [], 0
        for ln in lines:
            try:
                rec = json.loads(ln)
                key = rec.get("archive") if isinstance(rec, dict) \
                    else None
            except json.JSONDecodeError:
                kept.append(ln)  # torn tail: replay ignores it anyway
                continue
            if key in targets:
                dropped += 1
                continue
            kept.append(ln)
        if dropped:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.writelines(kept)
            os.replace(tmp, path)
    return dropped


def settle_fit(queue, info, checkpoint, drop_blocks, cancelled,
               wrote_block, outcome):
    """Common completion guard for workload ``fit_one``s — the exact
    discipline of the toas path (execute.py ``_fit_one``):

    * watchdog-cancelled -> NO ledger transition (the watchdog's
      ``fail`` record owns the archive's state);
    * lease taken over mid-fit -> abandon with no transition and drop
      any block this fit just wrote (never double-write);
    * otherwise ``outcome()`` performs the workload's transition and
      the ``runner_archive`` event is emitted with the workload tag.
    """
    if cancelled is not None and cancelled.is_set():
        return None
    if not queue.owns(info.path, refresh=True):
        from .execute import _lease_lost

        _lease_lost(queue, info, checkpoint, wrote_block=wrote_block,
                    drop=drop_blocks)
        return None
    rec = outcome()
    obs.event("runner_archive", archive=info.path,
              workload=queue.workload, state=rec["state"],
              attempts=rec.get("attempts", 0),
              reason=rec.get("reason"))
    return rec["state"]


# -- the interface -----------------------------------------------------

class Workload:
    """One pluggable work-unit type for the survey engine.

    The engine (execute.py ``run_survey``) supplies the loop — plan
    order, lease claiming, heartbeats, watchdog, reconcile, obs —
    and delegates everything workload-specific here:

    * ``n_passes``/``pass_label``: how many sequential passes over the
      archive set (align iterates), and the ledger ``workload`` label
      of each (pass k's records never contend with pass k-1's);
    * ``checkpoint_path``/``resume_done``/``drop_blocks``: the
      per-process checkpoint protocol reconcile and takeover-scrub
      run against;
    * ``begin_pass``: per-pass setup (align loads the pass template);
    * ``make_bucket_state``: warm per-shape-bucket state (the toas
      bucketed GetTOAs + fitter) — return None when unused;
    * ``claim_fields``: extra fields stamped on the claim record (the
      toas workload surfaces the upstream zap decision chain);
    * ``fit_one``: process one claimed archive end to end — load, fit,
      checkpoint, then exactly one ledger transition guarded by
      :func:`settle_fit`;
    * ``end_pass``: the per-pass reduce (align's weighted average);
      must be idempotent and safe for ANY process to run once the
      pass's union ledger shows every archive settled.
    """

    name = None
    #: end_pass does real work (engine records a ``reduce`` phase)
    has_reduce = False
    #: archives are padded to their bucket's canonical shape
    uses_buckets = True
    #: fit_one's load phase goes through GetTOAs._load_archive, so the
    #: claim-ahead host prefetch stage (runner/prefetch.py) can run it
    #: on a worker thread and replay the outcome via preload()
    supports_prefetch = False

    def n_passes(self, plan):
        return 1

    def pass_label(self, ipass=0):
        return self.name if ipass == 0 \
            else "%s.i%d" % (self.name, ipass + 1)

    def checkpoint_path(self, workdir, pid, ipass=0):
        return os.path.join(workdir, "%s.%d.jsonl"
                            % (self.pass_label(ipass), pid))

    def resume_done(self, checkpoint, quiet=True):
        """Archives (realpaths) with a complete block in this
        checkpoint."""
        return set(read_jsonl_checkpoint(checkpoint))

    def drop_blocks(self, checkpoint, archives):
        return drop_jsonl_checkpoint_blocks(checkpoint, archives)

    def begin_pass(self, ipass, plan, workdir, quiet=True):
        pass

    def end_pass(self, ipass, plan, workdir, queue, pid, quiet=True):
        return None

    def make_bucket_state(self, bucket, ordered, fitter, quiet=True):
        return None

    def claim_fields(self, queue, info):
        return {}

    def fit_one(self, state, queue, info, checkpoint, padded, quiet,
                cancelled=None):
        raise NotImplementedError

    def summary_extra(self):
        """Workload-specific fields merged into the survey manifest."""
        return {}


# -- toas: the original workload, bit-identical ------------------------

class ToasWorkload(Workload):
    """Wideband/narrowband TOA measurement through bucketed GetTOAs —
    exactly the engine's pre-workload behavior (same checkpoint files,
    same ledger transitions, same compiled-program reuse)."""

    name = DEFAULT_WORKLOAD
    supports_prefetch = True

    def __init__(self, modelfile=None, narrowband=False,
                 get_toas_kw=None, device=None):
        if modelfile is None:
            raise ValueError("run_survey needs a modelfile (argument "
                             "or recorded on the plan)")
        self.modelfile = modelfile
        self.narrowband = bool(narrowband)
        self.get_toas_kw = dict(get_toas_kw or {})
        self.device = device

    def checkpoint_path(self, workdir, pid, ipass=0):
        return os.path.join(workdir, "toas.%d.tim" % pid)

    def resume_done(self, checkpoint, quiet=True):
        from ..pipelines.toas import _resume_checkpoint

        if not os.path.isfile(checkpoint):
            return set()
        return _resume_checkpoint(checkpoint, quiet)

    def drop_blocks(self, checkpoint, archives):
        from ..pipelines.toas import drop_checkpoint_blocks

        return drop_checkpoint_blocks(checkpoint, archives)

    def make_bucket_state(self, bucket, ordered, fitter, quiet=True):
        from .execute import _BucketedGetTOAs

        gt = _BucketedGetTOAs(
            [i.path for i, b in ordered if b.key == bucket.key],
            self.modelfile, bucket.key, quiet=quiet, device=self.device)
        gt.fit_batch = fitter
        return gt

    def claim_fields(self, queue, info):
        # pre-fit chain: a zap pass over this workdir recorded its
        # decisions in the union ledger — surface them in this claim's
        # reason chain so the toas ledger narrates what preceded the
        # fit
        zrec = queue.record_for(ZapWorkload.name, info.path)
        if zrec is None or zrec.get("state") != DONE:
            return {}
        nz = int(zrec.get("n_zapped") or 0)
        return {"pre_fit": {"zap": {"n_zapped": nz,
                                    "owner": zrec.get("owner")}},
                "reason": "pre_fit zap: %d channel-weight(s) zeroed"
                          % nz}

    def fit_one(self, state, queue, info, checkpoint, padded, quiet,
                cancelled=None):
        from .execute import _fit_one

        return _fit_one(state, queue, info, checkpoint, padded,
                        self.get_toas_kw, quiet, cancelled=cancelled,
                        narrowband=self.narrowband)


# -- zap: per-archive RFI excision -------------------------------------

class ZapWorkload(Workload):
    """Model-free median-noise channel zapping applied in place.

    Per archive: ``load_data`` (the ``archive_read`` chaos site fires
    inside it, so zap inherits the toas fault surface),
    ``get_zap_channels`` proposals, ``apply_zaps`` zeroing the flagged
    channel weights via the in-repo PSRFITS writer.  The checkpoint
    block records the full proposal; the ledger done record carries
    ``n_zapped``/``n_proposed`` for the downstream toas pass's
    ``pre_fit`` chain.  Re-zapping an already-zapped archive is
    idempotent (the weights are already zero), so a takeover refit
    cannot corrupt data."""

    name = "zap"
    uses_buckets = False

    def __init__(self, nstd=3.0, tscrunch=False, all_subs=None,
                 device=None):
        # the load runs on ``device``; the proposal walk and the weight
        # rewrite are host numpy
        self.device = device
        self.nstd = float(nstd)
        self.tscrunch = bool(tscrunch)
        # ppzap semantics: tscrunched examination applies zaps to all
        # subints (paz -z vs -z -w)
        self.all_subs = self.tscrunch if all_subs is None \
            else bool(all_subs)

    def fit_one(self, state, queue, info, checkpoint, padded, quiet,
                cancelled=None):
        from ..io.archive import load_data
        from ..pipelines.zap import apply_zaps, get_zap_channels

        wrote = False
        try:
            # same load flags as ppzap's model-free path
            d = load_data(info.path, dedisperse=False,
                          dededisperse=False, tscrunch=self.tscrunch,
                          pscrunch=True, rm_baseline=True,
                          refresh_arch=False, return_arch=False,
                          quiet=True, device=self.device)
            zaps = get_zap_channels(d, nstd=self.nstd)
            n_prop = sum(len(z) for z in zaps)
            n_zapped = 0
            if n_prop:
                results = apply_zaps([info.path], [zaps],
                                     all_subs=self.all_subs,
                                     modify=True, quiet=True)
                n_zapped = sum(n for _, n in results)
            append_jsonl_checkpoint(checkpoint, {
                "archive": os.path.realpath(info.path),
                "t": round(time.time(), 6),
                "nstd": self.nstd,
                "n_proposed": n_prop,
                "n_zapped": n_zapped,
                "zap_channels": [[int(c) for c in z] for z in zaps],
            }, key=info.path)
            wrote = True
        except Exception as e:
            err = "%s: %s" % (type(e).__name__, e)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.fail(info.path, err))
        return settle_fit(
            queue, info, checkpoint, self.drop_blocks, cancelled,
            wrote,
            lambda: queue.complete(info.path, n_zapped=n_zapped,
                                   n_proposed=n_prop))


# -- align: claimable accumulate units + per-pass reduce ---------------

class AlignWorkload(Workload):
    """Iterative align-and-average (``pipelines/align.align_archives``)
    as claimable per-archive units.

    Pass k fits every archive's subints against the pass template (the
    initial guess for pass 0, the previous reduce's output after) and
    writes its weighted partial sums — the exact per-row math of
    ``_align_fit_accumulate``, whose rows are independent, so summing
    per-archive parts equals the reference's cross-archive batches up
    to float associativity — atomically to
    ``align_parts/<pass>/*.npz``.  ``end_pass`` is the reduce: sum
    every done archive's part, normalize by total weights, write the
    next pass template (or the final aligned archive + an
    ``align.result.npz`` with the raw portrait/weights).  The reduce
    is deterministic and idempotent (atomic rename), so ANY process
    that observes pass completion may perform it and kill/resume
    replays no archive already accumulated."""

    name = "align"
    has_reduce = True
    uses_buckets = False

    def __init__(self, initial_guess=None, fit_dm=True, tscrunch=False,
                 pscrunch=True, SNR_cutoff=0.0, niter=1, norm=None,
                 rot_phase=0.0, place=None, max_iter=30, outfile=None,
                 chunk_max=128, device=None):
        if initial_guess is None:
            raise ValueError(
                "align workload needs an initial_guess template "
                "archive (ppsurvey run -m / workload_opts"
                "={'initial_guess': ...})")
        self.initial_guess = initial_guess
        self.fit_dm = bool(fit_dm)
        self.tscrunch = bool(tscrunch)
        self.pscrunch = bool(pscrunch)
        self.SNR_cutoff = float(SNR_cutoff)
        self.niter = max(1, int(niter))
        self.norm = norm
        self.rot_phase = float(rot_phase)
        self.place = place
        self.max_iter = int(max_iter)
        self.outfile = outfile
        self.chunk_max = int(chunk_max)
        self.device = device
        self._outputs = {}

    def n_passes(self, plan):
        return self.niter

    def _state(self):
        return "Intensity" if self.pscrunch else "Stokes"

    def _pass_template(self, workdir, ipass):
        """Template consumed by pass ``ipass`` (0-based)."""
        if ipass == 0:
            return self.initial_guess
        return os.path.join(workdir,
                            "align.template.%d.fits" % (ipass + 1))

    def _final_out(self, workdir):
        return self.outfile or os.path.join(workdir, "aligned.fits")

    def _result_path(self, workdir):
        return os.path.join(workdir, "align.result.npz")

    def begin_pass(self, ipass, plan, workdir, quiet=True):
        from ..io.archive import load_data

        src = self._pass_template(workdir, ipass)
        md = load_data(src, state=self._state(), dedisperse=True,
                       tscrunch=True, pscrunch=self.pscrunch,
                       rm_baseline=True, refresh_arch=True,
                       return_arch=True, quiet=True, device=self.device)
        self.model_data = md
        self.nchan, self.nbin = int(md.nchan), int(md.nbin)
        self.npol = 1 if self.pscrunch else 4
        self.model_port = (md.masks * md.subints)[0, 0]
        self.model_mask = np.zeros(self.nchan)
        self.model_mask[md.ok_ichans[0]] = 1.0
        self._parts_dir = os.path.join(workdir, "align_parts",
                                       self.pass_label(ipass))
        os.makedirs(self._parts_dir, exist_ok=True)

    def _part_path(self, path):
        key = os.path.realpath(path)
        h = hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()
        return os.path.join(self._parts_dir, "%s.%s.npz"
                            % (os.path.basename(key), h[:12]))

    def resume_done(self, checkpoint, quiet=True):
        # a checkpointed block is only trustworthy while its part file
        # exists — a lost part must refit, never silently drop its
        # archive from the average
        recs = read_jsonl_checkpoint(checkpoint)
        return {k for k, r in recs.items()
                if not r.get("part") or os.path.isfile(r["part"])}

    def fit_one(self, state, queue, info, checkpoint, padded, quiet,
                cancelled=None):
        from ..io.archive import load_data

        wrote = False
        try:
            with obs.span("load", archive=info.path):
                d = load_data(info.path, state=self._state(),
                              dedisperse=False, tscrunch=self.tscrunch,
                              pscrunch=self.pscrunch, rm_baseline=True,
                              refresh_arch=False, return_arch=False,
                              quiet=True, device=self.device)
        except NotImplementedError as e:
            # inconvertible state: deterministic, like align_archives'
            # permanent skip — quarantine with the reason on record
            err = "cannot convert to %s: %s" % (self._state(), e)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.quarantine(info.path, err))
        except Exception as e:
            # possibly transient (injected archive_read fault, NFS
            # blip): bounded retries, then quarantine — the engine's
            # standard fault isolation
            err = "%s: %s" % (type(e).__name__, e)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.fail(info.path, err))
        skip = None
        if d.nbin != self.nbin:
            err = "nbin mismatch: %d != template %d" % (d.nbin,
                                                        self.nbin)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.quarantine(info.path, err))
        if d.prof_SNR < self.SNR_cutoff:
            skip = "prof_SNR %.1f < cutoff %.1f" % (d.prof_SNR,
                                                    self.SNR_cutoff)
        ok = np.asarray(d.ok_isubs)
        if skip is None and not len(ok):
            skip = "no usable subints"
        try:
            part = None
            n_rows = 0
            if skip is None:
                aligned, weights, n_rows = self._accumulate(d, ok,
                                                            info.path)
                part = self._part_path(info.path)
                tmp = part + ".tmp.npz"
                np.savez(tmp, aligned=aligned, weights=weights)
                os.replace(tmp, part)
            append_jsonl_checkpoint(checkpoint, {
                "archive": os.path.realpath(info.path),
                "t": round(time.time(), 6),
                "part": part,
                "n_rows": int(n_rows),
                "skipped": skip,
            }, key=info.path)
            wrote = True
        except Exception as e:
            err = "%s: %s" % (type(e).__name__, e)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.fail(info.path, err))
        return settle_fit(
            queue, info, checkpoint, self.drop_blocks, cancelled,
            wrote,
            lambda: queue.complete(info.path, n_rows=int(n_rows),
                                   part=part, skipped=skip))

    def _accumulate(self, d, ok, path):
        """This archive's weighted partial sums against the pass
        template — the exact entry construction + batched
        seed/fit/rotate/accumulate of ``align_archives``, restricted
        to one archive's rows.  The block and the sums live on the
        workload's device; the parts are returned as host numpy."""
        import torch

        from ..config import real_dtype, resolve_device
        from ..pipelines.align import (_align_fit_accumulate,
                                       _assemble_block,
                                       _guess_fit_freqs_np)

        dev = resolve_device(self.device)

        def up(x):
            return torch.as_tensor(x, dtype=real_dtype, device=dev)

        aligned = torch.zeros((self.npol, self.nchan, self.nbin),
                              dtype=real_dtype, device=dev)
        weights = torch.zeros((self.nchan, self.nbin), dtype=real_dtype,
                              device=dev)
        model_port = up(self.model_port)
        md = self.model_data
        same_freqs = d.freqs.shape[-1] == self.nchan and \
            np.allclose(d.freqs[0], md.freqs[0])
        wok = (d.weights[ok] > 0.0).astype(float)
        if same_freqs:
            wok = wok * self.model_mask[None, :]
            chan_map = None
        else:
            chan_map = np.argmin(np.abs(
                md.freqs[0][None, :] - d.freqs[0][:, None]), axis=1)
        entry = dict(
            full=np.asarray(d.subints[ok]),
            freqs=np.asarray(d.freqs[ok]),
            errs=np.asarray(d.noise_stds[ok, 0]),
            SNRs=np.asarray(d.SNRs[ok, 0]),
            Ps=np.asarray(d.Ps[ok]),
            wok=wok, chan_map=chan_map, DM=float(d.DM))
        rows = [(entry, j) for j in range(len(ok))]
        dnchan = d.freqs.shape[-1]
        for i0 in range(0, len(rows), self.chunk_max):
            take = rows[i0:i0 + self.chunk_max]
            block, cmaps = _assemble_block(
                take, dnchan, self.nchan, self.nbin, self.npol,
                self.chunk_max)
            full, tmpl_chans, freqs_b, errs_b, SNRs_b, Ps_b, wok_b, \
                DMg = block
            if dnchan == self.nchan and all(cm is None for cm in cmaps):
                model_b = model_port
            else:
                model_b = model_port[torch.as_tensor(tmpl_chans,
                                                     device=dev)]
            nu_fit = _guess_fit_freqs_np(freqs_b, SNRs_b, wok_b)
            with obs.span("solve", archive=path, rows=len(take)):
                _align_fit_accumulate(
                    up(full), model_b, *(up(a) for a in (
                        freqs_b, errs_b, nu_fit, Ps_b, wok_b, DMg)),
                    chan_maps=cmaps, fit_dm=self.fit_dm,
                    max_iter=self.max_iter, nbin=self.nbin,
                    npol=self.npol, aligned_port=aligned,
                    total_weights=weights)
        return (aligned.detach().cpu().numpy(),
                weights.detach().cpu().numpy(), len(rows))

    def end_pass(self, ipass, plan, workdir, queue, pid, quiet=True):
        final = ipass == self.niter - 1
        out = self._final_out(workdir) if final \
            else self._pass_template(workdir, ipass + 1)
        result = self._result_path(workdir)
        if final:
            self._outputs = {"aligned": out, "result": result}
        if os.path.isfile(out) and (not final
                                    or os.path.isfile(result)):
            return out  # another process already reduced this pass
        aligned = np.zeros((self.npol, self.nchan, self.nbin))
        weights = np.zeros((self.nchan, self.nbin))
        n_parts = 0
        for key in sorted(queue.entries):
            rec = queue.entries[key]
            if rec.get("state") != DONE:
                continue
            part = rec.get("part")
            if not part or not os.path.isfile(part):
                continue
            with np.load(part) as z:
                aligned += z["aligned"]
                weights += z["weights"]
            n_parts += 1
        nz = weights > 0
        for ipol in range(self.npol):
            aligned[ipol][nz] /= weights[nz]
        if final:
            aligned = self._finalize_port(aligned)
        arch = self.model_data.arch.copy()
        arch.tscrunch()
        if self.pscrunch:
            arch.pscrunch()
        arch.DM = 0.0
        arch.dedispersed = False
        arch.data = np.asarray(aligned)[None]
        arch.weights = np.where(weights.sum(axis=-1) > 0.0, 1.0,
                                0.0)[None, :]
        tmp = out + ".tmp.fits"
        arch.unload(tmp, quiet=True)
        os.replace(tmp, out)
        if final:
            tmpr = result + ".tmp.npz"
            np.savez(tmpr, aligned_port=aligned, total_weights=weights)
            os.replace(tmpr, result)
        obs.event("align_reduce", iteration=ipass + 1,
                  n_parts=n_parts, outfile=out, final=final)
        return out

    def _finalize_port(self, aligned):
        """Final-pass cosmetics, matching align_archives: optional
        normalization, rotation, and fiducial-point placement (on the
        workload's device; host numpy in and out)."""
        import torch

        from ..config import real_dtype, resolve_device
        from ..fit.phase_shift import fit_phase_shift
        from ..ops.fourier import rotate_data
        from ..ops.normalize import normalize_portrait
        from ..ops.profiles import gaussian_profile

        dev = resolve_device(self.device)
        port = torch.as_tensor(aligned, dtype=real_dtype, device=dev)
        if self.norm in ("mean", "max", "prof", "rms", "abs"):
            port = torch.stack([normalize_portrait(port[ipol], self.norm)
                                for ipol in range(self.npol)])
        if self.rot_phase:
            port = rotate_data(port, self.rot_phase)
        if self.place is not None:
            prof = port[0].mean(dim=0)
            delta = prof.max() * gaussian_profile(self.nbin, self.place,
                                                  0.0001, device=dev)
            phase = fit_phase_shift(prof, delta, Ns=self.nbin,
                                    device=dev).phase
            port = rotate_data(port, phase)
        return port.detach().cpu().numpy()

    def summary_extra(self):
        return dict(self._outputs)


# -- modelfit: ppgauss/ppspline over averaged portraits ----------------

class ModelFitWorkload(Workload):
    """Gaussian or spline portrait-model construction, one model per
    archive, written under ``<workdir>/models/``.  The heavy per-model
    optimization gets the engine's fault isolation, retries, leases
    and resume for free — a survey's worth of template archives models
    itself overnight and a preempted run continues where it stopped."""

    name = "modelfit"
    uses_buckets = False

    def __init__(self, kind="gauss", outdir=None, model_kw=None,
                 device=None):
        if kind not in ("gauss", "spline"):
            raise ValueError("modelfit kind must be 'gauss' or "
                             "'spline', not %r" % (kind,))
        self.kind = kind
        self.outdir = outdir
        self.model_kw = dict(model_kw or {})
        self.device = device

    def begin_pass(self, ipass, plan, workdir, quiet=True):
        if self.outdir is None:
            self.outdir = os.path.join(workdir, "models")
        os.makedirs(self.outdir, exist_ok=True)

    def _model_out(self, path):
        base = os.path.basename(path)
        stem = base.rsplit(".", 1)[0] or base
        ext = ".gmodel" if self.kind == "gauss" else ".spl.npz"
        return os.path.join(self.outdir, stem + ext)

    def fit_one(self, state, queue, info, checkpoint, padded, quiet,
                cancelled=None):
        wrote = False
        try:
            outfile = self._model_out(info.path)
            if self.kind == "gauss":
                from ..models.gauss import GaussianModelPortrait

                dp = GaussianModelPortrait(info.path, quiet=True,
                                           device=self.device)
                dp.make_gaussian_model(quiet=True, **self.model_kw)
                out = dp.write_model(outfile, quiet=True)
            else:
                from ..models.spline import SplineModelPortrait

                sp = SplineModelPortrait(info.path, quiet=True,
                                         device=self.device)
                sp.make_spline_model(**self.model_kw)
                out = sp.write_model(outfile, quiet=True)
            append_jsonl_checkpoint(checkpoint, {
                "archive": os.path.realpath(info.path),
                "t": round(time.time(), 6),
                "kind": self.kind,
                "model": out,
            }, key=info.path)
            wrote = True
        except Exception as e:
            err = "%s: %s" % (type(e).__name__, e)
            return settle_fit(queue, info, checkpoint,
                              self.drop_blocks, cancelled, wrote,
                              lambda: queue.fail(info.path, err))
        return settle_fit(
            queue, info, checkpoint, self.drop_blocks, cancelled,
            wrote,
            lambda: queue.complete(info.path, model=out,
                                   kind=self.kind))


# -- registry ----------------------------------------------------------

_REGISTRY = {}


def register_workload(name, factory):
    """Register a workload factory under a name (``ppsurvey run
    --workload <name>`` resolves here)."""
    _REGISTRY[str(name)] = factory


def workload_names():
    return sorted(_REGISTRY)


def get_workload(name, **opts):
    try:
        factory = _REGISTRY[str(name)]
    except KeyError:
        raise ValueError("unknown workload %r (registered: %s)"
                         % (name, ", ".join(workload_names())))
    return factory(**opts)


def resolve_workload(spec, modelfile=None, narrowband=False,
                     get_toas_kw=None, opts=None, device=None):
    """``run_survey``'s ``workload`` argument -> a Workload instance.

    ``None``/"toas" keeps the original TOA-survey behavior (including
    the modelfile requirement); other names resolve through the
    registry with ``opts`` as constructor keywords.  For ``align``,
    ``modelfile`` doubles as the default ``initial_guess`` (the CLI's
    ``-m`` flag).  ``device`` is every named workload's default device
    (an explicit ``opts["device"]`` wins).  A Workload instance passes
    through untouched."""
    if isinstance(spec, Workload):
        return spec
    name = str(spec) if spec else ToasWorkload.name
    if name == ToasWorkload.name:
        return ToasWorkload(modelfile=modelfile,
                            narrowband=narrowband,
                            get_toas_kw=get_toas_kw, device=device)
    if get_toas_kw:
        raise TypeError(
            "unexpected get_toas keyword(s) for workload %r: %s"
            % (name, ", ".join(sorted(get_toas_kw))))
    opts = dict(opts or {})
    if device is not None and name in _BUILTIN:
        opts.setdefault("device", device)
    if name == AlignWorkload.name and modelfile is not None:
        opts.setdefault("initial_guess", modelfile)
    return get_workload(name, **opts)


#: the workloads defined here, whose constructors take ``device``
_BUILTIN = (ToasWorkload.name, ZapWorkload.name, AlignWorkload.name,
            ModelFitWorkload.name)

register_workload(ToasWorkload.name, ToasWorkload)
register_workload(ZapWorkload.name, ZapWorkload)
register_workload(AlignWorkload.name, AlignWorkload)
register_workload(ModelFitWorkload.name, ModelFitWorkload)
