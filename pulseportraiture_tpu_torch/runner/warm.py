"""Bucket warm-up: build the kernels and prime every planned fit shape.

The PyTorch port of the JAX package's ``runner/warm.py``: the ONE warm
implementation shared by the daemon (``ppserve warm``; service/warm.py
re-exports it) and the batch engine (``ppsurvey warm`` / ``ppsurvey run
--warm``).  It turns a :class:`~.plan.SurveyPlan` bucket enumeration
into the set of *programs* the pipeline will dispatch and makes each
one warm before the first real archive:

* **Program enumeration** (:func:`program_specs`): archives group by
  ``(bucket shape, nsub)`` — the batched solver's identity is the
  reference's padded batch shape (:func:`solver_program`), and the
  guess stage keys on the raw ``nsub``.
  ``coalesce`` multipliers add the combined-batch specs a micro-batcher
  would dispatch.  ``workloads`` extends the enumeration beyond
  GetTOAs: align/zap/modelfit get one spec per ``(bucket, nsub)``
  each.  The specs equal the reference's for the same plan.
* **Kernel build directory** (:func:`enable_persistent_cache`): where
  the JAX package points XLA's persistent compilation cache, the port
  points the build directory of its hand-written kernels
  (``_kernels.set_build_dir``): ``nvcc`` then runs once per machine and
  every later worker loads the built libraries.
* **Build stage** (``aot=True``, on the card): every kernel source is
  built (or loaded from the build directory) up front, one ``nvcc`` per
  source, all at once — the counterpart of the reference's
  ahead-of-time compile.  Eager PyTorch compiles nothing per shape, so
  this is the only compile there is; with ``aot=False`` each kernel is
  built at its first launch instead.
* **Execution stage**: each ``(bucket, nsub)`` class runs ONE synthetic
  archive end-to-end through the real driver (``GetTOAs`` for toas;
  the align block math, the zap proposal walk, or a gaussian model fit
  for the workload-engine variants) on the run's device.  On the card
  this builds the kernels the path launches (K1, K2; K3 with
  ``fit_scat``) and fills cuFFT's plan cache for the bucket's shapes.

Synthetic archives are built from the caller's own model when one is
given or from a canonical gaussian pulse for the model-free workloads:
data = model + noise at exactly the bucket's canonical shape.  Every
warmed program emits a ``warm_program`` obs event with its kernel-build
delta (``backend_compiles``: ``nvcc`` builds; ``compile_cache_hits`` /
``compile_cache_misses``: libraries found / not found in the build
directory, obs/monitor.py); a failing program records its error and
the warm pass continues — warm is never fatal.
"""

import os
import time

import numpy as np

from .. import obs
from ..fit.portrait import auto_scan_size, bucket_batch_size
from ..testing import faults
from ..utils.databunch import DataBunch
from ..utils.mjd import MJD
from .plan import SurveyPlan

__all__ = ["WarmSpec", "program_specs", "warm_plan",
           "enable_persistent_cache", "synth_databunch",
           "solver_program", "write_warm_archive"]

#: workloads the warm pass knows how to prime (runner/workloads.py
#: names); anything else enumerates no specs
WARM_WORKLOADS = ("toas", "zap", "align", "modelfit")


def enable_persistent_cache(cache_dir):
    """Build the port's hand-written kernels into, and load them from,
    ``cache_dir`` (``_kernels.set_build_dir``): the counterpart of the
    JAX package's persistent XLA compilation cache.

    Degrades, never fails: a corrupt/unwritable dir (or an injected
    ``compile_cache`` fault) emits a ``compile_cache_degraded`` obs
    event and returns False — the run proceeds with the package's own
    build directory.  Returns True when the directory is active.
    """
    try:
        faults.check("compile_cache", key=str(cache_dir))
        cache_dir = os.path.abspath(str(cache_dir))
        os.makedirs(cache_dir, exist_ok=True)
        if not os.access(cache_dir, os.W_OK):
            raise OSError("compile-cache dir not writable: %s"
                          % cache_dir)
        from .. import _kernels

        _kernels.set_build_dir(cache_dir)
        return True
    except Exception as e:
        obs.event("compile_cache_degraded", cache_dir=str(cache_dir),
                  error="%s: %s" % (type(e).__name__, e))
        obs.counter("compile_cache_degraded")
        return False


def solver_program(nsub):
    """(scan_size, padded_batch) identity of the batched-solver program
    the reference dispatches for a ``nsub``-row fit (its pipelines/toas.py
    + fit_portrait_full_batch's target logic); the spec labels."""
    scan = auto_scan_size(nsub)
    if scan is None:
        return None, max(nsub, bucket_batch_size(nsub))
    if nsub <= scan:
        return None, nsub
    return scan, -(-nsub // scan) * scan


class WarmSpec:
    """One program class to warm."""

    __slots__ = ("bucket", "native", "nsub", "n_archives", "kind",
                 "batch", "scan_size", "nu0", "bw", "workload")

    def __init__(self, bucket, nsub, n_archives=1, kind="archive",
                 native=None, nu0=1500.0, bw=800.0, workload="toas"):
        self.bucket = tuple(bucket)
        self.native = tuple(native) if native else self.bucket
        self.nsub = int(nsub)
        self.n_archives = int(n_archives)
        self.kind = kind  # "archive" (full pipeline) | "coalesced"
        self.workload = str(workload)
        self.scan_size, self.batch = solver_program(self.nsub)
        self.nu0 = float(nu0) or 1500.0
        self.bw = float(bw) or 800.0

    def to_dict(self):
        return {"bucket": "%dx%d" % self.bucket,
                "native": "%dx%d" % self.native, "nsub": self.nsub,
                "n_archives": self.n_archives, "kind": self.kind,
                "batch": self.batch, "scan_size": self.scan_size,
                "workload": self.workload}


def program_specs(plan, coalesce=(), workloads=("toas",)):
    """Enumerate the programs a plan's buckets will dispatch.

    Archive specs group by ``(bucket, native shape, nsub)``: the
    solver programs key on the padded bucket+batch shape, but the
    load-path estimates (io/archive.load_data) run at the archive's
    *native* shape before padding, so each native class warms its own
    end-to-end walk.

    ``coalesce``: extra batch multipliers K — for each bucket, the
    combined-batch solver program of K modal-``nsub`` archives sharing
    one micro-batch cycle.  Combined programs that pad to a batch
    already covered by a per-archive spec are skipped (power-of-two
    bucketing makes that the common case).  Coalescing only applies to
    the toas workload (the micro-batcher serves GetTOAs requests).

    ``workloads``: which engines' program sets to enumerate — any of
    ``("toas", "zap", "align", "modelfit")``; each non-toas workload
    adds one spec per ``(bucket, native, nsub)`` class with
    ``spec.workload`` set, warmed by that workload's own executor.
    """
    if isinstance(plan, str):
        plan = SurveyPlan.load(plan)
    groups = {}
    for info, bucket in plan.archives():
        key = (bucket.key, (info.nchan, info.nbin), info.nsub)
        if key not in groups:
            groups[key] = WarmSpec(bucket.key, info.nsub, 0,
                                   native=(info.nchan, info.nbin),
                                   nu0=info.nu0, bw=info.bw)
        groups[key].n_archives += 1
    specs = sorted(groups.values(),
                   key=lambda s: (s.bucket, s.native, s.nsub))
    out = []
    if "toas" in workloads:
        out.extend(specs)
        # coalesced specs dedupe only among themselves: even when the
        # PADDED solver program matches an archive spec's, the
        # batch-glue programs (broadcasts/stacks in
        # fit_portrait_full_batch) key on the raw combined batch size,
        # so each distinct total must run
        covered = set()
        for spec in specs:
            for k in coalesce:
                if k <= 1:
                    continue
                c = WarmSpec(spec.bucket, spec.nsub * int(k),
                             spec.n_archives, kind="coalesced",
                             nu0=spec.nu0, bw=spec.bw)
                ident = (c.bucket, c.nsub)
                if c.nsub != spec.nsub and ident not in covered:
                    covered.add(ident)
                    out.append(c)
    for wl in workloads:
        if wl == "toas" or wl not in WARM_WORKLOADS:
            continue
        for spec in specs:
            out.append(WarmSpec(spec.bucket, spec.nsub,
                                spec.n_archives, native=spec.native,
                                nu0=spec.nu0, bw=spec.bw, workload=wl))
    return out


def _bucket_freqs(spec, native=False):
    """Per-channel frequencies for the spec's native or bucket grid
    (shapes are what matter; the values only steer the model
    evaluation)."""
    nchan = spec.native[0] if native else spec.bucket[0]
    step = spec.bw / nchan
    return spec.nu0 + step * (np.arange(nchan) + 0.5) - spec.bw / 2.0


def _synth_model(nchan, nbin):
    """Canonical gaussian pulse portrait for the model-free workloads
    (zap/align/modelfit warm only needs data of the right *shape* with
    one resolvable component)."""
    phases = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((phases - 0.5) / 0.05) ** 2)
    return np.broadcast_to(prof, (nchan, nbin)).copy()


def synth_databunch(model, freqs, nsub, P=0.005, noise_frac=0.02,
                    seed=0, name="warm"):
    """In-memory DataBunch shaped like a loaded+padded archive: data is
    the model plus ``noise_frac`` noise, all channels live."""
    rng = np.random.default_rng(seed)
    model = np.asarray(model, dtype=np.float64)
    nchan, nbin = model.shape
    sigma = noise_frac * max(float(np.abs(model).max()), 1e-12)
    subints = np.broadcast_to(model, (nsub, 1, nchan, nbin)) \
        + rng.normal(0.0, sigma, (nsub, 1, nchan, nbin))
    freqs_b = np.broadcast_to(np.asarray(freqs, dtype=np.float64),
                              (nsub, nchan)).copy()
    noise_stds = np.full((nsub, 1, nchan), sigma)
    snr = np.abs(model).mean(-1) / sigma
    return DataBunch(
        arch=None, backend="warm", backend_delay=0.0,
        bw=float(freqs[-1] - freqs[0]) if nchan > 1 else 1.0,
        doppler_factors=np.ones(nsub), doppler_degraded=False,
        DM=0.0, dmc=False,
        epochs=[MJD.from_mjd(56000.0 + 1e-5 * i) for i in range(nsub)],
        filename=name, flux_prof=None, freqs=freqs_b, frontend="warm",
        integration_length=nsub * 1.0,
        masks=np.ones((nsub, 1, nchan, nbin)), nbin=nbin, nchan=nchan,
        noise_stds=noise_stds, npol=1, nsub=nsub,
        nu0=float(np.mean(freqs)),
        ok_ichans=[np.arange(nchan)] * nsub,
        ok_isubs=np.arange(nsub),
        parallactic_angles=np.zeros(nsub),
        phases=(np.arange(nbin) + 0.5) / nbin,
        prof=model.mean(0), prof_noise=sigma / np.sqrt(nchan),
        prof_SNR=float(snr.mean()) * nchan,
        Ps=np.full(nsub, float(P)),
        SNRs=np.broadcast_to(snr, (nsub, 1, nchan)).copy(),
        source=name, state="warm", subints=subints,
        subtimes=np.full(nsub, 60.0), telescope="warm",
        telescope_code="0", weights=np.ones((nsub, nchan)))


def _fit_kwargs(get_toas_kw):
    """The fit-configuration subset of the driver kwargs (the settings
    that shape the fits; the reference's TPU-only polish/coarse knobs
    are not the port's)."""
    kw = dict(get_toas_kw or {})
    out = {}
    for key in ("tscrunch", "fit_DM", "fit_GM", "fit_scat",
                "log10_tau", "fix_alpha", "max_iter", "bary",
                "nonfinite_max_frac"):
        if key in kw:
            out[key] = kw[key]
    return out


class _CompileWatch:
    """Compile / persistent-cache counter deltas around a warm step,
    read from the active obs recorder (0s when obs is off): the
    ``nvcc`` builds and build-directory hits/misses obs/monitor.py
    publishes."""

    KEYS = ("backend_compiles", "compile_cache_hits",
            "compile_cache_misses")

    def __init__(self):
        self._rec = obs.current()
        self._base = self._snap()

    def _snap(self):
        if self._rec is None:
            return {k: 0 for k in self.KEYS}
        return {k: int(self._rec.counters.get(k, 0)) for k in self.KEYS}

    def delta(self):
        now = self._snap()
        return {k: now[k] - self._base[k] for k in self.KEYS}


_WARM_EPHEMERIS = ("PSR WARM\nRAJ 00:00:00\nDECJ 00:00:00\n"
                   "F0 200.0\nPEPOCH 56000.0\nDM 0.0\n")


def write_warm_archive(spec, model, outfile, seed=0):
    """Unload a synthetic PSRFITS archive of the spec's *native* shape
    (data = ``model`` + noise) — model-agnostic, unlike
    ``io.archive.make_fake_pulsar`` (which needs a .gmodel)."""
    from ..io.psrfits import Archive

    nchan, nbin = spec.native
    rng = np.random.default_rng(seed)
    model = _host(model)
    sigma = 0.02 * max(float(np.abs(model).max()), 1e-12)
    data = np.broadcast_to(model, (spec.nsub, 1, nchan, nbin)) \
        + rng.normal(0.0, sigma, (spec.nsub, 1, nchan, nbin))
    freqs = _bucket_freqs(spec, native=True)
    epochs = [MJD.from_mjd(56000.0 + 1e-3 * i)
              for i in range(spec.nsub)]
    arch = Archive(data, freqs, np.ones((spec.nsub, nchan)),
                   np.full(spec.nsub, 0.005), epochs,
                   np.full(spec.nsub, 60.0), DM=0.0,
                   dedispersed=False, source="WARM",
                   nu0=spec.nu0, bw=spec.bw,
                   ephemeris_text=_WARM_EPHEMERIS,
                   doppler_factors=np.ones(spec.nsub),
                   parallactic_angles=np.zeros(spec.nsub))
    arch.unload(outfile, quiet=True)
    return outfile


def _host(x):
    """Host float64 numpy of a tensor or array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _warm_archive_spec(spec, modelfile, get_toas_kw, narrowband, quiet,
                       device, workdir=None):
    """Run one synthetic archive of the spec's class end-to-end —
    PSRFITS write, real ``load_data``, bucket padding, guess, fit — on
    ``device``.  The real load path matters: its estimates run at the
    archive's native shape."""
    import shutil
    import tempfile

    from .execute import _BucketedGetTOAs

    tmp = tempfile.mkdtemp(prefix="ppwarm_", dir=workdir)
    try:
        gt0 = _BucketedGetTOAs([], modelfile, spec.bucket, quiet=True,
                               device=device)
        nchan, nbin = spec.native
        model = gt0._build_model(
            _bucket_freqs(spec, native=True),
            (np.arange(nbin) + 0.5) / nbin, 0.005,
            fit_scat=bool((get_toas_kw or {}).get("fit_scat")))
        path = write_warm_archive(
            spec, model, os.path.join(tmp, "warm_%dx%d_n%d.fits"
                                      % (spec.native + (spec.nsub,))))

        gt = _BucketedGetTOAs([path], modelfile, spec.bucket,
                              quiet=True, device=device)
        fit_kw = _fit_kwargs(get_toas_kw)
        if narrowband:
            for key in ("bary", "fit_DM", "fit_GM", "fix_alpha"):
                fit_kw.pop(key, None)
            gt.get_narrowband_TOAs(datafile=path, quiet=True, **fit_kw)
        else:
            gt.get_TOAs(datafile=path, quiet=True, **fit_kw)
        if not gt.order and not quiet:
            print("warm: %s produced no fit (model/config mismatch?)"
                  % path)
        return len(gt.order) > 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _warm_coalesced_spec(spec, modelfile, get_toas_kw, device):
    """Warm a combined-batch fit directly, as the pipeline calls the
    batched fit (the guess stage stays per-archive and is covered by the
    archive specs): the batch the service's micro-batcher
    (service/batcher.py) dispatches when several requests share a
    cycle, primed at that shape on ``device`` (kernels, cuFFT plans,
    the caching allocator's blocks)."""
    from ..fit.portrait import fit_portrait_full_batch, model_kmax
    from .execute import _BucketedGetTOAs

    gt = _BucketedGetTOAs([], modelfile, spec.bucket, quiet=True,
                          device=device)
    freqs = _bucket_freqs(spec)
    fit_kw = _fit_kwargs(get_toas_kw)
    fit_scat = bool(fit_kw.get("fit_scat"))
    model = _host(gt._build_model(
        freqs, (np.arange(spec.bucket[1]) + 0.5) / spec.bucket[1],
        0.005, fit_scat=fit_scat))
    d = synth_databunch(model, freqs, spec.nsub)
    B = spec.nsub
    ports = d.subints[:, 0]
    models_b = np.broadcast_to(model, ports.shape)
    nu_mean = float(np.mean(freqs))
    init = np.stack([np.zeros(B), np.full(B, d.DM), np.zeros(B),
                     np.zeros(B), np.zeros(B)], axis=1)
    flags = (1, int(fit_kw.get("fit_DM", True)),
             int(fit_kw.get("fit_GM", False)), 0, 0)
    fit_portrait_full_batch(
        ports, models_b, init, d.Ps, d.freqs, errs=d.noise_stds[:, 0],
        weights=d.weights, fit_flags=flags,
        nu_fits=np.full((B, 3), nu_mean), nu_outs=None, bounds=None,
        log10_tau=False, max_iter=int(fit_kw.get("max_iter", 50)),
        kmax=model_kmax(model), device=gt.device)
    return True


def _warm_zap_spec(spec):
    """Prime the zap proposal walk at the spec's native shape.

    ``pipelines/zap.get_zap_channels`` is pure numpy — this spec
    honestly records zero backend compiles; it exists so the warm
    report enumerates the workload's program set (and stays correct if
    the proposal stage ever moves on-device)."""
    from ..pipelines.zap import get_zap_channels

    freqs = _bucket_freqs(spec, native=True)
    d = synth_databunch(_synth_model(*spec.native), freqs, spec.nsub)
    get_zap_channels(d, nstd=3)
    return True


def _warm_align_spec(spec, device):
    """Prime the align block for the spec's native shape: one padded
    subint block through seed (``_rotate_batch``, ``fit_phase_shift``),
    the batched (phi, DM) portrait fit, and the rotate-accumulate — the
    exact per-row math of ``AlignWorkload._accumulate``, on ``device``.

    Best-effort: at run time the template's (nchan, nbin) comes from
    the initial-guess archive; the plan's native shape is the right
    warm target for the self-aligned survey case (template built from
    the survey's own archives)."""
    import torch

    from ..config import real_dtype, resolve_device
    from ..pipelines.align import (_align_fit_accumulate, _assemble_block,
                                   _guess_fit_freqs_np)

    dev = resolve_device(device)

    def up(x):
        return torch.as_tensor(x, dtype=real_dtype, device=dev)

    nchan, nbin = spec.native
    model_np = _synth_model(nchan, nbin)
    model_port = up(model_np)
    freqs = _bucket_freqs(spec, native=True)
    d = synth_databunch(model_np, freqs, spec.nsub)
    ok = np.asarray(d.ok_isubs)
    entry = dict(
        full=np.asarray(d.subints[ok]),
        freqs=np.asarray(d.freqs[ok]),
        errs=np.asarray(d.noise_stds[ok, 0]),
        SNRs=np.asarray(d.SNRs[ok, 0]),
        Ps=np.asarray(d.Ps[ok]),
        wok=(d.weights[ok] > 0.0).astype(float),
        chan_map=None, DM=float(d.DM))
    rows = [(entry, j) for j in range(len(ok))]
    aligned = torch.zeros((1, nchan, nbin), dtype=real_dtype, device=dev)
    weights = torch.zeros((nchan, nbin), dtype=real_dtype, device=dev)
    chunk_max = 128
    for i0 in range(0, len(rows), chunk_max):
        take = rows[i0:i0 + chunk_max]
        block, cmaps = _assemble_block(take, nchan, nchan, nbin, 1,
                                       chunk_max)
        full, _, freqs_b, errs_b, SNRs_b, Ps_b, wok_b, DMg = block
        nu_fit = _guess_fit_freqs_np(freqs_b, SNRs_b, wok_b)
        _align_fit_accumulate(
            up(full), model_port, *(up(a) for a in (
                freqs_b, errs_b, nu_fit, Ps_b, wok_b, DMg)),
            chan_maps=cmaps, fit_dm=True, max_iter=30, nbin=nbin,
            npol=1, aligned_port=aligned, total_weights=weights)
    return True


def _warm_modelfit_spec(spec, device, workdir=None):
    """Prime the gaussian model-fit programs (``lm_solve`` via
    ``make_gaussian_model``) against a synthetic archive of the spec's
    native shape.

    Best-effort: the LM program set keys on the seeded component count,
    which for real data depends on the profile — the canonical
    single-gaussian warm covers the dominant programs."""
    import shutil
    import tempfile

    from ..models.gauss import GaussianModelPortrait

    tmp = tempfile.mkdtemp(prefix="ppwarm_", dir=workdir)
    try:
        path = write_warm_archive(
            spec, _synth_model(*spec.native),
            os.path.join(tmp, "warm_%dx%d_n%d.fits"
                         % (spec.native + (spec.nsub,))))
        dp = GaussianModelPortrait(path, quiet=True, device=device)
        dp.make_gaussian_model(quiet=True)
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _warm_one(spec, modelfile, get_toas_kw, narrowband, quiet, device):
    if spec.kind == "coalesced":
        return _warm_coalesced_spec(spec, modelfile, get_toas_kw, device)
    if spec.workload == "zap":
        return _warm_zap_spec(spec)
    if spec.workload == "align":
        return _warm_align_spec(spec, device)
    if spec.workload == "modelfit":
        return _warm_modelfit_spec(spec, device)
    return _warm_archive_spec(spec, modelfile, get_toas_kw, narrowband,
                              quiet, device)


def warm_plan(plan, modelfile=None, get_toas_kw=None, coalesce=(),
              aot=True, narrowband=False, quiet=True,
              workloads=("toas",), device=None):
    """Warm every program a plan enumerates on ``device`` (None = the
    CUDA device); returns the summary dict.  ``aot`` builds every
    kernel source first, all at once, when ``device`` is a CUDA device
    (module docstring).

    Emits one ``warm_program`` obs event per spec (compile +
    persistent-cache deltas) and ``warm_programs``/``warm_compiles``
    counters.  Programs that were already warm in this process report
    ``compiles == 0`` — the idempotence a resumed daemon or survey
    worker relies on.  A failing program records its error in the
    event/summary (``ok=False``) and the pass continues: warm is
    best-effort by contract, never fatal.
    """
    from ..config import resolve_device

    device = resolve_device(device)
    if isinstance(plan, str):
        plan = SurveyPlan.load(plan)
    # the plan's model unless one is given (as run_survey does; the
    # reference's warm_plan has no such fallback and fails every toas
    # program of a CLI warm without -m)
    modelfile = modelfile or plan.modelfile
    specs = program_specs(plan, coalesce=coalesce, workloads=workloads)
    t0 = time.perf_counter()
    total = _CompileWatch()
    if aot and device.type == "cuda":
        from .. import _kernels

        with obs.span("warm_build"):
            build_s = _kernels.build()
        obs.event("warm_build", build_s=round(build_s, 6),
                  build_dir=_kernels.BUILD_DIR)
    done = []
    for spec in specs:
        watch = _CompileWatch()
        ts = time.perf_counter()
        err = None
        try:
            ok = _warm_one(spec, modelfile, get_toas_kw, narrowband,
                           quiet, device)
        except Exception as e:
            ok, err = False, "%s: %s" % (type(e).__name__, e)
        d = watch.delta()
        entry = dict(spec.to_dict(), ok=bool(ok),
                     dur_s=round(time.perf_counter() - ts, 6), **d)
        if err is not None:
            entry["error"] = err
        done.append(entry)
        # "kind" collides with the event sink's own field name
        obs.event("warm_program", **{
            ("program_kind" if k == "kind" else k): v
            for k, v in entry.items()})
        obs.counter("warm_programs")
        if d["backend_compiles"]:
            obs.counter("warm_compiles", d["backend_compiles"])
        if not quiet:
            print("warm: %(bucket)s nsub=%(nsub)d batch=%(batch)s "
                  "kind=%(kind)s workload=%(workload)s "
                  "compiles=%(backend_compiles)d "
                  "cache_hits=%(compile_cache_hits)d "
                  "cache_misses=%(compile_cache_misses)d "
                  "(%(dur_s).1fs)" % entry)
    summary = {"n_programs": len(done), "programs": done,
               "wall_s": round(time.perf_counter() - t0, 6)}
    summary.update(total.delta())
    obs.event("warm_done", n_programs=len(done),
              wall_s=summary["wall_s"],
              backend_compiles=summary["backend_compiles"],
              compile_cache_hits=summary["compile_cache_hits"],
              compile_cache_misses=summary["compile_cache_misses"])
    return summary
