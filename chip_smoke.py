#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel from `min_tfs_client_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, times both beside
the bound and the library call, then drives the port's main path once at
full width: BERT-base (12 layers, hidden 768, seq 128, random weights from a
seed) written as a version directory and served in-process by
`boot_local_server`, Predict at batch 1 and 32. It checks that the path went
through the kernels (launch counts), that its outputs agree with the same
port run on the CPU, profiles where a served request spends its time, and
ends with one JSON line naming the device. Any failure exits non-zero.
Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16/fp16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# Kernel vs plain version on the card: |kernel - plain| <= atol + rtol *
# |plain| elementwise. bf16/f16: the kernel keeps P in f32 for the PV
# product while the plain version rounds P to the input dtype first (as the
# JAX reference does), and both round the output to 8 (bf16) or 11 (f16)
# mantissa bits, so one to two ulps. f32: both are f32 throughout; only the
# summation order differs.
KERNEL_TOL = {"bfloat16": (2e-2, 1e-2), "float16": (4e-3, 2e-3),
              "float32": (2e-5, 2e-5)}

# Served BERT-base logits, card (bf16 cuBLAS + the kernel) vs the same port
# on the CPU (plain attention), max abs error: bf16 rounds at other places
# in every one of the 12 layers. Measured 0.0078 at batch 4 on an H100 80GB
# HBM3 at 700 W; the limit is about four times that, and a row whose CPU
# margin exceeds it must keep its argmax.
LOGITS_TOL = 0.03

# Every hand-written kernel of the main path: name -> (wrapper module,
# wrapper, source, the TPU kernel it replaces).
KERNELS = {
    "flash_attention": ("min_tfs_client_tpu_torch.ops.attention",
                        "flash_attention",
                        "min_tfs_client_tpu_torch/csrc/flash_attention.cu",
                        "min_tfs_client_tpu/ops/attention.py:204"),
}

SEQ_LEN = 128
PREDICT = "/tensorflow.serving.PredictionService/Predict"
METADATA = "/tensorflow.serving.PredictionService/GetModelMetadata"


def log(msg) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_kernels() -> float:
    from min_tfs_client_tpu_torch.ops import _kernels

    start = time.perf_counter()
    logs = _kernels.build()
    seconds = time.perf_counter() - start
    for name in _kernels.KERNELS:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    log(f"build: {len(_kernels.KERNELS)} kernel(s) in {seconds:.2f} s")
    return seconds


def _attention_inputs(shape, skv, dtype, lengths, seed, head_split=False):
    """q (B,H,Sq,D) and k, v (B,H,Skv,D) on the card. `head_split` lays
    them out as layers.mha hands them over: (B,H,S,D) views of contiguous
    (B,S,H*D) projections."""
    import numpy as np
    import torch

    b, h, sq, d = shape
    rng = np.random.default_rng(seed)

    def make(s):
        dims = (b, s, h, d) if head_split else (b, h, s, d)
        x = torch.from_numpy(rng.standard_normal(dims).astype(np.float32)).to(
            device="cuda", dtype=getattr(torch, dtype))
        return x.transpose(1, 2) if head_split else x

    q, k, v = make(sq), make(skv), make(skv)
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def _mixed_lengths(b, skv, seed):
    """Mixed key lengths with one zero-length row (when b > 1)."""
    import numpy as np

    lens = np.random.default_rng(seed).integers(1, skv + 1, b)
    if b > 1:
        lens[1] = 0
    return [int(x) for x in lens]


# (label, q shape, Skv, dtype, lengths, causal, causal_offset, head_split)
def kernel_cases():
    return [
        ("b32 bf16 mixed lengths", (32, 12, 128, 64), 128, "bfloat16",
         _mixed_lengths(32, 128, 1), False, None, False),
        ("b32 bf16 mha layout", (32, 12, 128, 64), 128, "bfloat16",
         _mixed_lengths(32, 128, 2), False, None, True),
        ("b1 bf16", (1, 12, 128, 64), 128, "bfloat16", [128], False, None,
         False),
        ("unaligned Skv=100", (2, 4, 100, 64), 100, "bfloat16", [100, 37],
         False, None, False),
        ("causal default offset", (2, 4, 200, 64), 200, "bfloat16", None,
         True, None, False),
        ("causal offset 0", (2, 4, 96, 64), 160, "bfloat16", None, True, 0,
         False),
        ("Sq=8 right-aligned", (2, 4, 8, 64), 72, "bfloat16", [72, 50], True,
         None, False),
        ("f32 D=128", (2, 4, 130, 128), 130, "float32", [130, 64], False,
         None, False),
        ("f16 D=32", (2, 4, 64, 32), 64, "float16", [64, 10], False, None,
         False),
    ]


def check_kernels() -> dict:
    """Kernel vs plain version on the card; exits non-zero on a miss.
    Returns {case label: max abs error}."""
    import torch

    from min_tfs_client_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
    )

    errors = {}
    for seed, (label, shape, skv, dtype, lengths, causal, offset,
               head_split) in enumerate(kernel_cases()):
        q, k, v, lens = _attention_inputs(shape, skv, dtype, lengths, seed,
                                          head_split)
        got = flash_attention(q, k, v, causal=causal, lengths=lens,
                              causal_offset=offset)
        want = attention_reference(q, k, v, causal=causal, lengths=lens,
                                   causal_offset=offset)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        atol, rtol = KERNEL_TOL[dtype]
        excess = float((diff - atol - rtol * want.float().abs()).max())
        finite = bool(torch.isfinite(got).all())
        log(f"kernel flash_attention [{label}] {tuple(shape)} Skv={skv} "
            f"{dtype}: max_abs_err={err:.3e} atol={atol:g} rtol={rtol:g} "
            f"finite={finite}")
        if lengths is not None and 0 in lengths:
            row = lengths.index(0)
            if bool(got[row].ne(0).any()):
                raise SystemExit(f"kernel case {label!r}: zero-length row "
                                 "is not zeros")
        if not finite or excess > 0:
            raise SystemExit(f"kernel case {label!r}: max_abs_err {err} "
                             f"outside atol {atol} + rtol {rtol}")
        errors[label] = err
    return errors


def _time_ms(fn, *, samples=25, reps=10) -> float:
    """Device time of one call: `reps` calls captured into a CUDA graph
    after warm-up, the graph replayed `samples` times between CUDA events;
    the median replay over `reps`. Host-side launch cost is left out (the
    serving phase's p50 carries it)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound_ms(shape, skv, dtype, lengths) -> tuple[float, str]:
    """Least time for this call on an H100 SXM: q read and o written in
    full, k and v read only up to each example's length; QK^T and PV over
    the valid keys (2 FLOP per multiply-add)."""
    b, h, sq, d = shape
    size = 4 if dtype == "float32" else 2
    valid = sum(min(max(n, 0), skv) for n in lengths) if lengths else b * skv
    nbytes = 2 * b * h * sq * d * size + 2 * h * valid * d * size + 4 * b
    flops = 4 * h * sq * d * valid
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels() -> dict:
    """Kernel, plain version and SDPA times at the main path's shapes, on
    inputs laid out as layers.mha hands them to the kernel."""
    import torch
    import torch.nn.functional as F

    from min_tfs_client_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
    )

    rows = {}
    for label, shape in (("b32", (32, 12, 128, 64)), ("b1", (1, 12, 128, 64))):
        lengths = _mixed_lengths(shape[0], 128, 7)
        q, k, v, lens = _attention_inputs(shape, 128, "bfloat16", lengths, 7,
                                          head_split=True)
        mask = (torch.arange(128, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        row = {
            "ms": _time_ms(lambda: flash_attention(q, k, v, lengths=lens)),
            "plain_ms": _time_ms(
                lambda: attention_reference(q, k, v, lengths=lens)),
            # Timed as a yardstick only; the port never calls it.
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            shape, 128, "bfloat16", lengths)
        rows[label] = row
        log(f"time flash_attention {label} {shape} bf16: "
            + json.dumps(row))
    return rows


def _bert_requests(batch, vocab, seed):
    """Token ids and right-padded masks of mixed lengths (row 0 full)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, SEQ_LEN)).astype(np.int32)
    lens = rng.integers(8, SEQ_LEN + 1, batch)
    lens[0] = SEQ_LEN
    mask = (np.arange(SEQ_LEN)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


class _Client:
    """Predict through LocalServer.invoke with PredictRequest protos when
    protobuf is installed, else the same inputs through the signature."""

    def __init__(self, server, model_name, wire: bool):
        self.server, self.model_name, self.wire = server, model_name, wire

    def request(self, ids, mask):
        from min_tfs_client_tpu_torch.protos import tfs_apis_pb2
        from min_tfs_client_tpu_torch.tensor.codec import (
            ndarray_to_tensor_proto,
        )

        req = tfs_apis_pb2.PredictRequest()
        req.model_spec.name = self.model_name
        req.inputs["input_ids"].CopyFrom(ndarray_to_tensor_proto(ids))
        req.inputs["attention_mask"].CopyFrom(ndarray_to_tensor_proto(mask))
        return req

    def predict(self, ids, mask):
        if not self.wire:
            sig = self.server.core.servable.signature("serving_default")
            out = sig.run({"input_ids": ids, "attention_mask": mask})
            return out["logits"], out["probabilities"]
        from min_tfs_client_tpu_torch.tensor.codec import (
            tensor_proto_to_ndarray,
        )

        resp = self.server.invoke(PREDICT, self.request(ids, mask))
        return (tensor_proto_to_ndarray(resp.outputs["logits"]),
                tensor_proto_to_ndarray(resp.outputs["probabilities"]))


def _check_outputs(logits, probs, batch, num_labels, label):
    import numpy as np

    for name, arr in (("logits", logits), ("probabilities", probs)):
        if arr.shape != (batch, num_labels) or arr.dtype != np.float32:
            raise SystemExit(f"{label}: {name} {arr.shape} {arr.dtype}")
        if not np.isfinite(arr).all():
            raise SystemExit(f"{label}: {name} not finite")
    if np.abs(probs.sum(-1) - 1).max() > 1e-5:
        raise SystemExit(f"{label}: probabilities do not sum to 1")


def _kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention (hand-written)"
    if any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other kernels"


def profile_serving(server, client, config, *, iters: int = 20) -> dict:
    """Where a served Predict spends its time, at batch 1 and 32: host wall
    per request, its stages (wire decode, Signature.run, wire encode; the
    wire stages only with protobuf), device time per request by kernel
    family from torch.profiler, and the device's idle share (1 - device
    time / unprofiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from min_tfs_client_tpu_torch.tensor import codec

    sig = server.core.servable.signature()
    report = {}
    for batch in (1, 32):
        ids, mask = _bert_requests(batch, config.vocab_size, batch)
        inputs = {"input_ids": ids, "attention_mask": mask}
        if client.wire:
            req = client.request(ids, mask)
            call = lambda: server.invoke(PREDICT, req)  # noqa: E731
        else:
            call = lambda: sig.run(inputs)  # noqa: E731
        for _ in range(3):
            call()
        stages = {"wall_ms": [], "run_ms": []}
        if client.wire:
            stages.update(decode_ms=[], encode_ms=[])
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            if client.wire:
                inputs = codec.tensor_protos_to_dict(req.inputs,
                                                     writable=False)
            t2 = time.perf_counter()
            outputs = sig.run(inputs)
            t3 = time.perf_counter()
            stages["wall_ms"].append((t1 - t0) * 1e3)
            stages["run_ms"].append((t3 - t2) * 1e3)
            if client.wire:
                for arr in outputs.values():
                    codec.ndarray_to_tensor_proto(arr)
                stages["decode_ms"].append((t2 - t1) * 1e3)
                stages["encode_ms"].append(
                    (time.perf_counter() - t3) * 1e3)
        row = {k: statistics.median(v) for k, v in stages.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        families: dict[str, float] = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                family = _kernel_family(evt.key)
                families[family] = (families.get(family, 0.0)
                                    + evt.self_device_time_total)
        device_ms = sum(families.values()) / 1e3 / iters
        row.update(device_ms=device_ms,
                   # None: the profiler saw no device time (not measured).
                   idle_share=(1 - device_ms / row["wall_ms"]
                               if device_ms else None),
                   device_ms_by_family={k: v / 1e3 / iters
                                        for k, v in sorted(families.items())})
        report[f"b{batch}"] = row
        log(f"profile b{batch}: " + json.dumps(row))
    return report


def serve_bert(workdir: pathlib.Path, *, iters: int = 20) -> dict:
    """The main path at full width: BERT-base written as a version
    directory, served by boot_local_server on the card, Predict at batch 1
    and 32. Returns per-kernel launch counts of the run, timings, and the
    profile of the served path (taken after the counts are read)."""
    import numpy as np

    from min_tfs_client_tpu_torch.models import bert, export
    from min_tfs_client_tpu_torch.server import local

    config = bert.BertConfig()
    start = time.perf_counter()
    tree = bert.init_params(np.random.default_rng(0), config)
    base = workdir / "bert_base"
    export.write_version_dir(base, 1, {}, export.flatten_params(tree),
                             {"seq_len": SEQ_LEN})
    del tree
    log(f"serve: wrote BERT-base (layers={config.num_layers} "
        f"hidden={config.hidden_size} heads={config.num_heads} "
        f"vocab={config.vocab_size}) in {time.perf_counter() - start:.2f} s")

    wire = importlib.util.find_spec("google.protobuf") is not None
    log(json.dumps({"wire": "PredictRequest through LocalServer.invoke"
                    if wire else "skipped: protobuf not installed"}))
    wrappers = {name: getattr(importlib.import_module(module), fn)
                for name, (module, fn, _, _) in KERNELS.items()}

    # The main path's run: every count at 0 just before, read just after.
    for wrapper in wrappers.values():
        wrapper.launches = 0
    start = time.perf_counter()
    server = local.boot_local_server(str(base))
    log(f"serve: boot_local_server on {server.core.device} in "
        f"{time.perf_counter() - start:.2f} s")
    client = _Client(server, "bert_base", wire)
    requests = 0
    result = {"p50_ms": {}, "p90_ms": {}}
    for batch in (1, 32):
        ids, mask = _bert_requests(batch, config.vocab_size, batch)
        times = []
        for i in range(iters + 2):
            t0 = time.perf_counter()
            logits, probs = client.predict(ids, mask)
            if i >= 2:  # the first two are warm-up
                times.append((time.perf_counter() - t0) * 1e3)
            requests += 1
            _check_outputs(logits, probs, batch, config.num_labels,
                           f"b{batch}")
        times.sort()
        result["p50_ms"][f"b{batch}"] = statistics.median(times)
        result["p90_ms"][f"b{batch}"] = times[int(0.9 * (len(times) - 1))]
        log(f"serve: BERT-base Predict b{batch} s{SEQ_LEN}: p50 "
            f"{result['p50_ms'][f'b{batch}']:.3f} ms over {iters} requests")
    ids4, mask4 = _bert_requests(4, config.vocab_size, 4)
    card_logits, _ = client.predict(ids4, mask4)
    requests += 1
    launches = {name: w.launches for name, w in wrappers.items()}
    result.update(launches=launches, requests=requests)
    log(f"serve: {requests} requests, kernel launches {launches}")
    idle = sorted(name for name, n in launches.items() if n == 0)
    if idle:
        raise SystemExit(f"kernels never launched on the main path: {idle}")
    per_request = config.num_layers
    if launches["flash_attention"] != per_request * requests:
        raise SystemExit(
            f"flash_attention launched {launches['flash_attention']} times "
            f"for {requests} requests; expected {per_request} per request")

    if wire:
        from min_tfs_client_tpu_torch.protos import tfs_apis_pb2

        req = tfs_apis_pb2.GetModelMetadataRequest()
        req.model_spec.name = "bert_base"
        req.metadata_field.append("signature_def")
        meta = server.invoke(METADATA, req)
        sigs = tfs_apis_pb2.SignatureDefMap()
        meta.metadata["signature_def"].Unpack(sigs)
        names = sorted(sigs.signature_def)
        if names != ["classify", "predict", "regress", "serving_default"]:
            raise SystemExit(f"GetModelMetadata: signatures {names}")
        log(f"serve: GetModelMetadata version "
            f"{meta.model_spec.version.value} signatures {names}")
    result["profile"] = profile_serving(server, client, config, iters=iters)
    local.shutdown_local_server(str(base))

    # The same port on the CPU (plain attention) on the batch-4 inputs.
    cpu_server = local.boot_local_server(str(base), device="cpu")
    cpu_logits, _ = _Client(cpu_server, "bert_base", wire).predict(ids4, mask4)
    local.shutdown_local_server(str(base))
    err = float(np.abs(card_logits - cpu_logits).max())
    margin = np.abs(cpu_logits[:, 0] - cpu_logits[:, 1])
    clear = margin > LOGITS_TOL
    agree = bool((card_logits[clear].argmax(-1)
                  == cpu_logits[clear].argmax(-1)).all())
    log(f"serve: b4 logits card vs CPU max_abs_err={err:.4f} "
        f"tol={LOGITS_TOL} argmax agrees on {int(clear.sum())}/4 clear rows: "
        f"{agree}")
    if err > LOGITS_TOL or not agree:
        raise SystemExit("card and CPU logits disagree")
    result["cpu_logits_max_abs_err"] = err
    return result


def main() -> int:
    import torch

    if not (pathlib.Path(__file__).resolve().parent
            / "min_tfs_client_tpu_torch" / "csrc").is_dir():
        # Never fall back to a copy of the package installed elsewhere: the
        # kernels are built from this checkout's sources.
        log("chip_smoke: min_tfs_client_tpu_torch/ is not beside this "
            "script; run it from the root of a checkout")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    card = device_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 cases stay f32
    build_kernels()
    errors = check_kernels()
    times = time_kernels()
    workdir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        served = serve_bert(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        b32 = times["b32"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": max(errors["b32 bf16 mixed lengths"],
                               errors["b32 bf16 mha layout"]),
            "ms": b32["ms"], "plain_ms": b32["plain_ms"],
            "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
            "library_ms": b32["library_ms"]})
    log(json.dumps({"serve_p50_ms": served["p50_ms"],
                    "serve_p90_ms": served["p90_ms"], "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
