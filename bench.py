"""Benchmark matrix: one JSON line per BASELINE.md config, on the GPU.

Line 1 (headline, BASELINE configs[1]): plmDCA RF00167 100-iteration fit
wall-clock vs the reference C++/OpenMP backend timed on this host (cached in
tests/goldens/ref_plm_rf00167_it100.npz).

Further lines:
  - plmDCA PF02826 (configs[2], protein, 8.35M params) vs the cached
    reference backend timing;
  - mfDCA RF00167 compute_fn --apc (configs[0]) vs the reference mean-field
    engine executed from /root/reference (numba stubbed to pure numpy —
    numba is not installable on this host; cached in
    tests/goldens/ref_mf_timing.json);
  - plm gradient model-FLOPs/s and fraction of the chip's bf16 matmul peak
    (MFU) on the PF02826 problem;
  - 100k-sequence streaming fit throughput and 32-family vmapped batch
    throughput (configs[3]/[4]; the reference has no counterpart — baseline
    reported as 0).

Cold lines (``*_cold_wallclock``) time the first call in this process with
the persistent compilation cache off: true XLA compile + execute.

Each line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"card": "<nvidia-smi name, power.limit>"}; vs_baseline > 1 means faster
than the reference on the same host.  The reference timings are history
from the host they were taken on.
"""

import json
import os
import subprocess
import sys
import time

import jax

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
RF00167 = "/root/reference/examples/MSA_RF00167.fa"
PF02826 = "/root/reference/tests/tests_input/PF02826.faa"
ITERS = 100

# Dense peaks per device, keyed by jax device_kind (NVIDIA H100 SXM data
# sheet, at the full 700 W power limit).  A card missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "tf32": 495e12, "int8": 1979e12, "hbm": 3.35e12,
    },
}


def peak(kind: str, rate: str) -> float:
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device_kind {kind!r}; add it to PEAKS")
    return PEAKS[kind][rate]


CARD = ""  # the card's name and power limit (runtime.card), set by main


def emit(metric, value, unit, vs_baseline, note=None):
    line = {
        "metric": metric,
        "value": round(value, 4),
        "unit": unit,
        "vs_baseline": round(vs_baseline, 2) if vs_baseline is not None else 0,
        "card": CARD,
    }
    if note:
        line["note"] = note
    print(json.dumps(line), flush=True)


def ref_plm_seconds(name):
    import numpy as np

    path = os.path.join(GOLDENS, f"ref_plm_{name}_it100.npz")
    if os.path.exists(path):
        return float(np.load(path)["seconds"])
    return None


def ref_mf_seconds():
    path = os.path.join(GOLDENS, "ref_mf_timing.json")
    if os.path.exists(path):
        return json.load(open(path))["mf_rf00167_fn_apc_seconds"]
    return None


def bench_plm(msa_file, biomolecule, name, runs=3):
    import jax.numpy as jnp

    from pydca_tpu import read_msa, stats
    from pydca_tpu.plm import fit_plm

    msa = read_msa(msa_file, biomolecule)
    l, q = msa.seqs_len, msa.q
    m = jnp.asarray(msa.data, jnp.int32)
    w = stats.sequence_weights(m, 0.8, q)
    jax.block_until_ready(w)
    lam = jnp.float32(0.2 * (l - 1))

    def run():
        t0 = time.time()
        res = fit_plm(m, w, lam, lam, l, q, max_iterations=ITERS)
        jax.block_until_ready(res.x)
        return time.time() - t0

    cold = run()  # first call: pays the one-time JIT compilation
    ref_s = ref_plm_seconds(name)
    emit(
        f"plmdca_{name}_100it_cold_wallclock",
        cold,
        "s",
        (ref_s / cold) if ref_s else None,
    )
    dt = min(run() for _ in range(runs))
    emit(
        f"plmdca_{name}_100it_wallclock",
        dt,
        "s",
        (ref_s / dt) if ref_s else None,
    )
    return msa, m, w, lam


def bench_mf():
    from pydca_tpu.meanfield import MeanFieldDCA

    def run():
        t0 = time.time()
        inst = MeanFieldDCA(RF00167, "rna", pseudocount=0.5, seqid=0.8)
        scores = inst.compute_sorted_FN_APC()
        assert scores[0][1] > 0
        return time.time() - t0

    ref_s = ref_mf_seconds()
    # Cold: XLA compile of the fused pipeline program + execute + fetch
    cold = run()
    emit(
        "mfdca_rf00167_fn_apc_cold_wallclock",
        cold,
        "s",
        (ref_s / cold) if ref_s else None,
    )
    # min-of-4: the wall is a short device pipeline + one batched fetch
    dt = min(run() for _ in range(4))
    emit(
        "mfdca_rf00167_fn_apc_wallclock",
        dt,
        "s",
        (ref_s / dt) if ref_s else None,
        note="reference timed with numba stubbed to pure numpy (numba not "
        "installable here); vs a real numba install the multiplier is smaller",
    )


def bench_mfu(msa, m, w, lam):
    """Model-FLOPs/s of the plm objective+gradient on PF02826.

    FLOP model: the data term is one (N, Lq) x (Lq, qL) matmul forward and
    one same-shape matmul in the backward pass (x is constant, only the
    coupling operand's gradient is needed): 4*N*(L*q)^2 matmul FLOPs per
    value_and_grad evaluation.  Elementwise softmax/regularizer FLOPs are
    excluded (model FLOPs, not hardware FLOPs), so this slightly
    *understates* utilization.

    Timed as a K-rep fori_loop INSIDE one jit, so host dispatch latency
    does not count against a millisecond-scale kernel.

    The loop carry consumes the loss AND a vdot over the FULL gradient:
    consuming only g[0] (r3) let XLA dead-code-eliminate the coupling
    half of the backward (the expansion VJP and parts of the backward
    matmul feed only g[l*q:]), silently inflating the r3 MFU ~2.6x.
    """
    import jax.numpy as jnp

    from pydca_tpu import plm as plm_mod

    l, q = msa.seqs_len, msa.q
    n = m.shape[0]
    x, maskq = plm_mod._prep_msa(m, l, q, jnp.float32)
    theta0 = plm_mod.init_params(m, w, l, q)
    grad_fn = jax.value_and_grad(plm_mod._plm_loss_prepped)
    mm_bf16 = plm_mod.default_mm_bf16()  # the precision fit_plm actually uses
    reps = 1500  # amortize the per-call dispatch and fetch to <1%

    @jax.jit
    def run(theta, shift):
        def step(i, acc):
            fx, g = grad_fn(
                theta + 0.0 * acc + shift, x, maskq, w, lam, lam, l, q, mm_bf16
            )
            # full-gradient consumption: no part of the backward can be DCE'd
            return acc + fx + jnp.vdot(g, g) * jnp.float32(1e-30)

        return jax.lax.fori_loop(0, reps, step, jnp.float32(0))

    float(run(theta0, jnp.float32(0)))  # compile + run-to-host
    dt = 1e9
    for trial in range(3):
        # vary an operand per trial so no result cache can short-circuit
        shift = jnp.float32(1e-12 * (trial + 1))
        t0 = time.time()
        float(run(theta0, shift))
        dt = min(dt, (time.time() - t0) / reps)
    flops = 4.0 * n * (l * q) ** 2
    tflops = flops / dt / 1e12

    # f32 operands run as TF32 under DEFAULT precision; bf16 at the bf16 rate
    rate = peak(jax.devices()[0].device_kind, "bf16" if mm_bf16 else "tf32")
    mfu = tflops * 1e12 / rate
    note = (
        "standalone value_and_grad program; the r5 fused fit no longer "
        "executes it per iteration (expansion rides per-direction, trials "
        "are elementwise) — see plm_fit_per_iter_ms"
    )
    emit("plm_grad_pf02826_model_tflops", tflops, "TFLOP/s", None, note=note)
    emit("plm_grad_pf02826_mfu", mfu * 100, "% of matmul peak", None, note=note)

    # honest production per-iteration cost of the fused fit (slope method:
    # two chunk lengths, epsilon=0 so the loop cannot exit early)
    x1h, maskq = plm_mod._prep_msa_jit(m, l, q)
    hist_bf16 = plm_mod.default_hist_bf16()

    def run_iters(iters):
        st = plm_mod._plm_fused_state0(
            m, w, lam, lam, l, q, 5, mm_bf16, hist_bf16
        )
        t0 = time.time()
        st = plm_mod._plm_fused_steps(
            st, x1h, maskq, w, lam, lam, l, q, iters, mm_bf16, 0.0
        )
        jax.block_until_ready(st.x)
        return time.time() - t0, int(st.k)

    best = {}
    for iters in (10, 110):
        run_iters(iters)
        b, k = 1e9, 0
        for _ in range(3):
            dt, k = run_iters(iters)
            b = min(b, dt)
        best[iters] = (b, k)
    (tlo, klo), (thi, khi) = best[10], best[110]
    per_iter = (thi - tlo) / max(khi - klo, 1)
    emit(
        "plm_fit_per_iter_ms",
        per_iter * 1e3,
        "ms",
        None,
        note="full fused iteration: direction+history (D-space HBM "
        "traffic, ~0 FLOPs) + 1 coupling expansion + 2 matmuls + "
        "pullback + ~1.3 elementwise line-search trials; MFU is the "
        "wrong lens for the D-space majority — wall time is the metric "
        "(100-iteration fit: see plmdca_pf02826_100it_wallclock)",
    )


def bench_deep():
    import numpy as np
    import jax.numpy as jnp

    from pydca_tpu import stats
    from pydca_tpu.plm import fit_plm

    n, l, q = 100_000, 120, 5
    rng = np.random.default_rng(0)
    base = rng.integers(0, q, size=(64, l))
    msa = base[rng.integers(0, 64, size=n)]
    flip = rng.random((n, l)) < 0.15
    msa = np.where(flip, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)
    m = jnp.asarray(msa)

    jax.block_until_ready(stats.sequence_weights(m, 0.8, q))  # compile + warm
    variants = [jnp.asarray(np.roll(msa, k, axis=0)) for k in (1, 2, 3)]
    wdt = 1e9  # min-of-3
    for mv in variants:
        t0 = time.time()
        jax.block_until_ready(stats.sequence_weights(mv, 0.8, q))
        wdt = min(wdt, time.time() - t0)
    emit("weights_100k_pair_identities", n * n / wdt / 1e9, "G pairs/s", None)
    w = stats.sequence_weights(m, 0.8, q)

    # N = 10^6 weighting (VERDICT r3 item 6): the identity-counts kernel
    # builds its one-hot in-kernel from the int8 codes, so this regime no
    # longer materializes the (N, L*q) one-hot (120 MB codes vs 600 MB+
    # one-hot here; 21 GB at protein L=1000).
    n1m = 1_000_000
    msa1m = base[rng.integers(0, 64, size=n1m)]
    flip1m = rng.random((n1m, l)) < 0.15
    msa1m = np.where(
        flip1m, rng.integers(0, q, size=(n1m, l)), msa1m
    ).astype(np.int32)
    m1m = jnp.asarray(msa1m)
    jax.block_until_ready(stats.sequence_weights(m1m, 0.8, q))  # compile + warm
    # pre-stage the variants on device OUTSIDE the timed window (the
    # 480 MB host copy + transfer would otherwise be timed), min-of-2
    variants_1m = [
        jax.device_put(jnp.asarray(np.roll(msa1m, k, axis=0)))
        for k in (1, 2)
    ]
    jax.block_until_ready(variants_1m)
    wdt = 1e9
    for mv in variants_1m:
        t0 = time.time()
        jax.block_until_ready(stats.sequence_weights(mv, 0.8, q))
        wdt = min(wdt, time.time() - t0)
    emit("weights_1m_pair_identities", n1m * n1m / wdt / 1e9, "G pairs/s", None)
    emit("weights_1m_wallclock", wdt, "s", None)
    del m1m, variants_1m

    # protein-shape deep weighting (r5, VERDICT r4 item 7): N=2x10^5,
    # L=1000, q=21 executes the in-kernel one-hot at the shape the
    # 21-GB-avoidance claim is about: the int32 codes are 0.8 GB on
    # device (int8 in-kernel), while the (N, L*q) one-hot this kernel
    # never builds would be ~17 GB here and 84 GB at N=10^6.
    np_, lp, qp = 200_000, 1000, 21
    basep = rng.integers(0, qp, size=(256, lp))
    msap = basep[rng.integers(0, 256, size=np_)]
    flipp = rng.random((np_, lp)) < 0.15
    msap = np.where(flipp, rng.integers(0, qp, size=(np_, lp)), msap).astype(
        np.int32
    )
    mp1 = jax.device_put(jnp.asarray(msap))
    jax.block_until_ready(stats.sequence_weights(mp1, 0.8, qp))  # compile + warm
    del mp1
    wdt = 1e9
    for k in (1, 2):
        # stage ONE 0.8 GB variant at a time
        mv = jax.device_put(jnp.asarray(np.roll(msap, k, axis=0)))
        jax.block_until_ready(mv)
        t0 = time.time()
        jax.block_until_ready(stats.sequence_weights(mv, 0.8, qp))
        wdt = min(wdt, time.time() - t0)
        del mv
    lpad = 1024  # the kernel pads L to its 128-site chunk
    tops = np_ * np_ * 2.0 * lpad * qp / wdt
    int8_peak = peak(jax.devices()[0].device_kind, "int8")
    emit("weights_200k_protein_wallclock", wdt, "s", None)
    emit(
        "weights_200k_protein",
        np_ * np_ / wdt / 1e9,
        "G pairs/s",
        None,
        note=f"L=1000 q=21: 2*Lpad*q int8 ops/pair -> {tops / 1e12:.0f} "
        f"TOP/s ({tops / int8_peak * 100:.0f}% of the int8 peak)",
    )
    del msap

    lam = jnp.float32(0.2 * (l - 1))

    from pydca_tpu.parallel import make_mesh

    mesh = make_mesh()  # streaming-on-the-mesh path: the blocks place
    #                     P(None, 'data', None) on every visible device

    def run(iters=50):
        # 50 iterations amortize the fixed host<->device round trips of a
        # chunked fit, so the line measures sustained streaming throughput
        t0 = time.time()
        r = fit_plm(
            m, w, lam, lam, l, q, max_iterations=iters, seq_block=16384,
            mesh=mesh,
        )
        jax.block_until_ready(r.x)
        return int(r.num_iters), time.time() - t0

    iters, cold = run()  # includes the scan-program compile
    emit("plm_100kseq_streaming_cold_s", cold, "s", None)
    iters, dt = run()
    iters2, dt2 = run()
    dt = min(dt, dt2)
    emit(
        "plm_100kseq_streaming_throughput",
        iters * n / dt / 1e6,
        "M seq-updates/s",
        None,
    )


def bench_protein_scale():
    """Protein-scale mean-field: synthetic L=1000, q=21 family (VERDICT r2 #5).

    The correlation matrix is 20000 x 20000; this substantiates the
    ops/linalg claim that the Cholesky + divide-and-conquer triangular
    inverse + SYRK runs in ~1 s territory on one chip, and proves the
    memory-lean corr-mat layout holds at L=1000 (no OOM).
    """
    import numpy as np
    import jax.numpy as jnp

    from pydca_tpu.meanfield import _mf_fused_pipeline
    from pydca_tpu.ops import linalg

    n, l, q = 4096, 1000, 21
    rng = np.random.default_rng(1)
    base = rng.integers(0, q, size=(128, l))
    msa = base[rng.integers(0, 128, size=n)]
    flip = rng.random((n, l)) < 0.2
    msa = np.where(flip, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)
    m = jnp.asarray(msa)

    def run():
        t0 = time.time()
        out = _mf_fused_pipeline(m, l, q, 0.8, 0.5, jnp.float32)
        jax.block_until_ready(out)
        return time.time() - t0

    cold = run()
    emit("mfdca_l1000_q21_pipeline_cold_s", cold, "s", None)
    warm = min(run() for _ in range(2))
    emit("mfdca_l1000_q21_pipeline_warm_s", warm, "s", None)

    # Standalone 20000^2 SPD inverse: min-of-3, varying the operand per run
    # so no result cache can short-circuit.
    d = l * (q - 1)
    key = jax.random.PRNGKey(0)
    a = jax.random.normal(key, (d, 256), jnp.float32)
    c = a @ a.T + d * jnp.eye(d, dtype=jnp.float32)
    jax.block_until_ready(linalg.spd_inverse(c))  # compile + warm

    def run_inv(shift):
        t0 = time.time()
        jax.block_until_ready(linalg.spd_inverse(c + shift))
        return time.time() - t0

    dt = min(run_inv(jnp.float32(k + 1.0)) for k in range(3))
    emit(f"spd_inverse_{d}sq_warm_s", dt, "s", None)


def bench_family():
    import numpy as np

    from pydca_tpu.alphabets import RNA
    from pydca_tpu.family import (
        FamilyBatch,
        bucket_families,
        family_plm_fit,
        padded_flop_stats,
    )
    from pydca_tpu.io.fasta import MSA

    # heterogeneous batch: N in [64, 512], L in [16, 64] — the realistic
    # Pfam-sweep regime where single-block padding burns device time on pad
    # rows/sites (VERDICT r3 item 8)
    f, nmax, lmax, q = 32, 512, 64, 5
    rng = np.random.default_rng(2)

    def synth(n, l, seed):
        r = np.random.default_rng(seed)
        base = r.integers(0, q, size=(16, l))
        msa = base[r.integers(0, 16, size=n)]
        flip = r.random((n, l)) < 0.15
        return np.where(flip, r.integers(0, q, size=(n, l)), msa).astype(np.int8)

    msas = [
        MSA(
            data=synth(
                int(rng.integers(nmax // 8, nmax + 1)),
                int(rng.integers(lmax // 4, lmax + 1)),
                k,
            ),
            alphabet=RNA,
        )
        for k in range(f)
    ]
    batch = FamilyBatch(msas)
    stats_d = padded_flop_stats(msas)
    stats_d["num_buckets"] = len(bucket_families(msas))

    def run_single():
        t0 = time.time()
        thetas, _ = family_plm_fit(batch, max_iterations=20)
        jax.block_until_ready(thetas)
        return time.time() - t0

    # fit-only, like run_single (family_plm_fit_bucketed also scores,
    # which is host-side numpy — not what this line compares)
    bucket_batches = [
        FamilyBatch([msas[i] for i in idxs], pad_to=key)
        for key, idxs in sorted(bucket_families(msas).items())
    ]

    def run_bucketed():
        t0 = time.time()
        outs = [
            family_plm_fit(b, max_iterations=20)[0] for b in bucket_batches
        ]
        jax.block_until_ready(outs)
        return time.time() - t0

    run_single()  # warm-up
    dt = min(run_single() for _ in range(2))
    emit("family_batch_32x20it", f * 20 / dt, "family-iters/s", None)
    run_bucketed()  # warm-up (compiles one program per bucket)
    # min-of-2: the bucketed path dispatches one program per bucket
    dtb = min(run_bucketed() for _ in range(2))
    emit("family_batch_32x20it_bucketed", f * 20 / dtb, "family-iters/s", None)
    emit(
        "family_batch_padded_flop_waste",
        stats_d["single_block_waste"],
        "x (single-block)",
        None,
    )
    emit(
        "family_batch_padded_flop_waste_bucketed",
        stats_d["bucketed_waste"],
        "x",
        None,
        note=f"{stats_d['num_buckets'] if 'num_buckets' in stats_d else 0} buckets",
    )


def bench_cli_cache_warm():
    """Second-process wall with a warm persistent compile cache.

    The number a real user experiences on run 2: a FRESH process whose XLA
    executables load from the persistent cache (``runtime.cache_dir()``,
    the same fixed path every CLI process uses) after a ``warmup``
    process filled it.  Runs as subprocesses BEFORE this process starts
    JAX on the card: a JAX process reserves most of the card's memory.
    """
    import shutil
    import tempfile

    out = tempfile.mkdtemp(prefix="pydca_cli_bench_")

    def run_cli(args, timeout=900):
        # a failed child is an error: no line may stand for a run that
        # did not happen on the card
        subprocess.run(
            [sys.executable, "-m", *args], timeout=timeout, check=True,
            stdout=subprocess.DEVNULL,
        )

    try:
        plan = [
            (
                "mfdca", "pydca_tpu.cli.mfdca_main",
                ["warmup", "rna", RF00167],
                ["compute_fn", "rna", RF00167, "--apc",
                 "--output_dir", os.path.join(out, "mf")],
            ),
            (
                "plmdca", "pydca_tpu.cli.plmdca_main",
                ["warmup", "rna", RF00167],
                ["compute_fn", "rna", RF00167, "--apc",
                 "--max_iterations", str(ITERS),
                 "--output_dir", os.path.join(out, "plm")],
            ),
        ]
        for name, mod, warm_argv, timed_argv in plan:
            run_cli([mod, *warm_argv])
            t0 = time.time()
            run_cli([mod, *timed_argv])
            emit(
                f"{name}_cli_cachewarm_wall_s",
                time.time() - t0,
                "s",
                None,
                note="fresh process, persistent compile cache warm",
            )
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main():
    # NOTE: the persistent compilation cache is deliberately NOT enabled
    # here, so the *_cold_wallclock lines measure true XLA compile cost.
    # CLI runs do enable it (pydca_tpu.runtime.enable_compilation_cache).
    from pydca_tpu import runtime

    global CARD
    only = sys.argv[1] if len(sys.argv) > 1 else "all"
    CARD = runtime.card()
    # No CPU fallback anywhere: the CLI children inherit the restriction to
    # CUDA (a child without the plugin fails, and run_cli raises), and this
    # process checks its own device before it measures anything.
    os.environ["JAX_PLATFORMS"] = "cuda"

    # MUST run first: spawns CLI subprocesses that need the card while this
    # process has not started JAX on it yet.
    if only in ("all", "cli"):
        bench_cli_cache_warm()
    runtime.require_gpu()

    if only in ("all", "plm"):
        bench_plm(RF00167, "rna", "rf00167")
    if only in ("all", "protein"):
        msa, m, w, lam = bench_plm(PF02826, "protein", "pf02826", runs=2)
        bench_mfu(msa, m, w, lam)
    if only in ("all", "mf"):
        bench_mf()
    if only in ("all", "deep"):
        bench_deep()
    if only in ("all", "family"):
        bench_family()
    if only in ("all", "protein1000"):
        bench_protein_scale()


if __name__ == "__main__":
    main()
