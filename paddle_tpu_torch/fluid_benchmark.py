"""The benchmark harness of benchmark/fluid on the port (parity:
benchmark/fluid_benchmark.py `parse_args` :32, `_DEFAULT_BATCH` :72,
`_feeds` :79, `_build` :107, `print_train_time` :136, `run_transformer`
:160, `run_transformer_native` :148, `run_static_model` :223 and `main`
:306): the same models, the
same RandomState(0) batches and the same examples/sec line, through the
port's Fluid API on the card.

    python -m paddle_tpu_torch.fluid_benchmark --model deepfm --json
    python -m paddle_tpu_torch.fluid_benchmark --model resnet \\
        --data_set imagenet --batch_size 64 --iterations 10
    python -m paddle_tpu_torch.fluid_benchmark --model mnist --device CPU
    python -m paddle_tpu_torch.fluid_benchmark --model transformer_native

`--device GPU` (the default) runs on cuda:0 and raises without CUDA;
`--device CPU` runs the plain PyTorch path on the CPU. `run_static_model`
is the JAX harness's recipe: Adam(--learning_rate) (under
``contrib.mixed_precision.decorate`` with --use_amp), the feeds staged
on the device once, --skip_batch_num warm-up steps, then --iterations
timed steps with the loss fetched every step as device tensors and read
after the timed loop (each step with --blocking_fetch).
`run_transformer_native` is the native flagship's tokens/s through
``bench.bench_transformer`` (batch 192 unless --batch_size; --iterations
timed after --skip_batch_num warm-up steps). `--json` prints
the JAX harness's keys. `--profile` runs the timed loop inside a
``profiler`` session (each step a ``record_event("iteration")``) and
prints the event table and, on the card, the device time by Fluid op
(``profiler.print_device_op_profile(top=25)``). `--update_method
nccl2` (or `spmd`) trains through ``fluid.ParallelExecutor``, as the
JAX harness does, one process a rank (the fleet's env contract,
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ENDPOINTS``; none set is one rank): NCCL on the card,
gloo with `--device CPU`, every rank fed the
same global batch, and examples/sec/chip divides by the world size.

    PADDLE_TRAINER_ID=0 PADDLE_TRAINERS_NUM=1 \
        python -m paddle_tpu_torch.fluid_benchmark --model resnet \
        --data_set imagenet --update_method nccl2
"""

import argparse
import contextlib
import json
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch benchmark harness")
    p.add_argument("--model", default="mnist",
                   choices=["mnist", "resnet", "vgg", "stacked_dynamic_lstm",
                            "machine_translation", "deepfm", "se_resnext",
                            "transformer", "transformer_native"])
    p.add_argument("--batch_size", type=int, default=None,
                   help="per-step global batch (model default if unset)")
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--pass_num", type=int, default=1)
    p.add_argument("--skip_batch_num", type=int, default=5,
                   help="warmup steps excluded from timing")
    p.add_argument("--device", default="GPU", choices=["GPU", "CPU"],
                   help="GPU: cuda:0 (raises without CUDA); CPU: the plain "
                        "PyTorch path on the CPU")
    p.add_argument("--update_method", default="local",
                   choices=["local", "spmd", "nccl2"],
                   help="spmd / nccl2: data parallel through "
                        "ParallelExecutor, one process a rank")
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--use_amp", action="store_true",
                   help="wrap the optimizer in contrib.mixed_precision."
                        "decorate (bf16 white-list ops)")
    p.add_argument("--data_set", default=None,
                   choices=[None, "cifar10", "imagenet", "flowers"],
                   help="resnet/vgg dataset variant (imagenet = 224x224, "
                        "1000 classes)")
    p.add_argument("--profile", action="store_true",
                   help="wrap the timed loop in the profiler; print the "
                        "event table and the device time by Fluid op")
    p.add_argument("--json", action="store_true",
                   help="also print one machine-readable JSON line")
    p.add_argument("--blocking_fetch", action="store_true",
                   help="copy the fetched loss to the host every step "
                        "inside the timed loop; by default the losses are "
                        "read after it")
    return p.parse_args(argv)


_DEFAULT_BATCH = {
    "mnist": 128, "resnet": 64, "vgg": 64, "stacked_dynamic_lstm": 32,
    "machine_translation": 16, "deepfm": 256, "se_resnext": 32,
    "transformer": 16,
}


def _feeds(model, batch, rng, data_set=None):
    """Synthetic reference-shaped batches, numpy."""
    if model == "mnist":
        return {"img": rng.rand(batch, 784).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    if model in ("resnet", "vgg", "se_resnext"):
        if data_set in ("imagenet", "flowers"):
            return {"img": rng.rand(batch, 3, 224, 224).astype(np.float32),
                    "label": rng.randint(0, 1000,
                                         (batch, 1)).astype(np.int64)}
        return {"img": rng.rand(batch, 3, 32, 32).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    if model == "stacked_dynamic_lstm":
        return {"words": rng.randint(0, 30000,
                                     (batch, 80)).astype(np.int64),
                "label": rng.randint(0, 2, (batch, 1)).astype(np.int64),
                "seq_len": rng.randint(8, 81, (batch, 1)).astype(np.int64)}
    if model == "machine_translation":
        return {"src_word": rng.randint(3, 10000,
                                        (batch, 50)).astype(np.int64),
                "src_len": rng.randint(4, 51, (batch, 1)).astype(np.int64),
                "trg_word": rng.randint(3, 10000,
                                        (batch, 50)).astype(np.int64),
                "trg_next": rng.randint(3, 10000,
                                        (batch, 50)).astype(np.int64),
                "trg_len": rng.randint(4, 51, (batch, 1)).astype(np.int64)}
    if model == "deepfm":
        return {"sparse_ids": rng.randint(0, int(1e5),
                                          (batch, 26)).astype(np.int64),
                "dense_x": rng.rand(batch, 13).astype(np.float32),
                "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
    raise ValueError(model)


def _build(model, data_set=None):
    """The model's network in the current program; returns its loss."""
    from . import models

    big = data_set in ("imagenet", "flowers")
    if model == "mnist":
        *_, loss, _acc = models.mnist.build(arch="mlp")
    elif model == "resnet":
        *_, loss, _acc = models.resnet.build(
            dataset="imagenet" if big else "cifar10")
    elif model == "vgg":
        *_, loss, _acc = models.vgg.build(
            dataset="imagenet" if big else "cifar10")
    elif model == "se_resnext" and big:
        *_, loss, _acc = models.se_resnext.build(
            class_dim=1000, img_shape=(3, 224, 224))
    elif model == "stacked_dynamic_lstm":
        *_, loss, _acc = models.stacked_lstm.build()
    elif model == "machine_translation":
        _, _, loss = models.machine_translation.build()
    elif model == "deepfm":
        _, _, loss, _auc = models.deepfm.build()
    elif model == "se_resnext":
        *_, loss, _acc = models.se_resnext.build(class_dim=10)
    else:
        raise ValueError(model)
    return loss


def print_train_time(start_time, end_time, num_samples, n_chips=1):
    """The reference's throughput line (fluid_benchmark.py:296-300)."""
    train_elapsed = end_time - start_time
    examples_per_sec = num_samples / train_elapsed
    print("\nTotal examples: %d, total time: %.5f, %.5f examples/sec, "
          "%d chip(s), %.5f examples/sec/chip\n" %
          (num_samples, train_elapsed, examples_per_sec, n_chips,
           examples_per_sec / n_chips), flush=True)
    return examples_per_sec


@contextlib.contextmanager
def _profiled(args):
    """With --profile, the block inside a profiler session, then the
    event table and the device table by Fluid op (top 25). Yields the
    marker a step runs in: ``record_event("iteration")``, or a null
    context without --profile."""
    if not args.profile:
        yield contextlib.nullcontext
        return
    from . import profiler

    profiler.start_profiler("All")
    try:
        yield lambda: profiler.record_event("iteration")
    finally:
        profiler.stop_profiler("total")
    profiler.print_device_op_profile(top=25)


def _place(args):
    return "cpu" if args.device == "CPU" else None


def run_transformer(args, seq_len=512):
    """Tokens/sec of the flagship built from the port's fluid.layers
    (models/transformer_fluid.py) in bf16 under the contrib AMP decorator
    and SGD, feeds on the device, the loss read every 12 steps (the JAX
    harness's run_transformer)."""
    import torch

    import paddle_tpu_torch as fluid
    from .async_engine import as_numpy
    from .models import transformer_fluid

    batch = args.batch_size or 160
    prog, sprog = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, sprog):
        _toks, _labs, loss = transformer_fluid.build(
            seq_len=seq_len, dtype="bfloat16",
            remat=(batch * seq_len > 160 * 512))
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(args.learning_rate),
            init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    exe, scope = fluid.Executor(_place(args)), fluid.Scope()
    exe.run(sprog, scope=scope)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 32000, (batch, seq_len)).astype(np.int32)
    labs = np.roll(toks, -1, axis=1).astype(np.int32)
    feed = {"tokens": torch.from_numpy(toks).to(exe.device),
            "labels": torch.from_numpy(labs).to(exe.device)}
    sync_every = 12
    out = None
    for _ in range(args.skip_batch_num):
        out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        float(as_numpy(out).ravel()[0])
    with _profiled(args) as event:
        t0 = time.perf_counter()
        for i in range(args.iterations):
            with event():
                out, = exe.run(prog, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)
            if (i + 1) % sync_every == 0:
                float(as_numpy(out).ravel()[0])
        last = float(as_numpy(out).ravel()[0])
        dt = time.perf_counter() - t0
    tokens_per_sec = args.iterations * batch * seq_len / dt
    print("\nTransformer-base (fluid.layers API): %.1f tokens/sec/chip "
          "(last loss %.4f)\n" % (tokens_per_sec, last), flush=True)
    return {"metric": "transformer_fluid_api_tokens_per_sec_per_chip",
            "value": round(tokens_per_sec, 1), "unit": "tokens/s/chip",
            "last_loss": round(last, 4)}


def run_transformer_native(args):
    """Tokens/sec of the native flagship (models/transformer.py) through
    ``bench.bench_transformer`` (the JAX harness's
    run_transformer_native)."""
    from . import bench

    with _profiled(args):
        tokens_per_sec, last_loss = bench.bench_transformer(
            steps=args.iterations, warmup=args.skip_batch_num,
            batch=args.batch_size or 192, device=_place(args))
    print("\nTransformer-base (native): %.1f tokens/sec/chip "
          "(last loss %.4f)\n" % (tokens_per_sec, last_loss), flush=True)
    return {"metric": "transformer_native_tokens_per_sec_per_chip",
            "value": round(tokens_per_sec, 1), "unit": "tokens/s/chip"}


def run_static_model(args, record=None):
    """Train `args.model` with the JAX harness's recipe and print its
    examples/sec line and the first and last loss. Returns the JAX
    harness's record. `record`, a dict, receives what the run leaves:
    the executor, scope, program, startup program, loss var and staged
    feed, the losses of every step, the host ms of each timed step and,
    on the card, each timed step's device ms (CUDA events around it) and
    the peak allocation in bytes; `pe` the ParallelExecutor of an
    nccl2 / spmd run (else None)."""
    import torch

    import paddle_tpu_torch as fluid
    from .async_engine import as_numpy

    batch = args.batch_size or _DEFAULT_BATCH[args.model]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _build(args.model, args.data_set)
        opt = fluid.optimizer.Adam(args.learning_rate)
        if args.use_amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    scope = fluid.Scope()
    n_chips, pe = 1, None
    if args.update_method in ("spmd", "nccl2"):
        pe = fluid.ParallelExecutor(use_cuda=args.device != "CPU",
                                    loss_name=loss.name, main_program=main,
                                    scope=scope)
        n_chips = pe.device_count
        exe = fluid.Executor(pe.device)
    else:
        exe = fluid.Executor(_place(args))
    on_card = exe.device.type == "cuda"
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    # staged once: device-resident feeds skip the per-step host copy
    feed = {k: torch.from_numpy(v).to(exe.device)
            for k, v in _feeds(args.model, batch, rng,
                               args.data_set).items()}
    if on_card:
        torch.cuda.synchronize(exe.device)
        torch.cuda.reset_peak_memory_stats(exe.device)
    raw, marks, host_ms = [], [], []
    num_samples = 0
    start = None
    with _profiled(args) as event:
        for it in range(args.skip_batch_num + args.iterations):
            timed = it >= args.skip_batch_num
            if it == args.skip_batch_num:
                if raw:
                    as_numpy(raw[-1])  # drain the warm-up before timing
                start = time.perf_counter()
                num_samples = 0
            if timed and on_card:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            th = time.perf_counter()
            with event():
                if pe is None:
                    out, = exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope, return_numpy=False)
                else:
                    out, = pe.run([loss.name], feed=feed,
                                  return_numpy=False)
                if args.blocking_fetch:
                    out = as_numpy(out)  # a host copy each step, timed
            if timed:
                host_ms.append((time.perf_counter() - th) * 1e3)
            raw.append(out)
            num_samples += batch
        if on_card:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        as_numpy(raw[-1])  # one stream runs in order: the last done
        end = time.perf_counter()
    losses = [float(as_numpy(o).mean()) for o in raw]
    eps = print_train_time(start, end, num_samples, n_chips)
    print("last loss: %.5f (first %.5f)" % (losses[-1], losses[0]),
          flush=True)
    if record is not None:
        record.update(
            exe=exe, pe=pe, scope=scope, program=main, startup=startup,
            loss=loss, feed=feed, batch=batch, losses=losses,
            host_ms=host_ms,
            examples_per_sec=eps,
            step_ms=[a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            if on_card else None,
            peak_bytes=torch.cuda.max_memory_allocated(exe.device)
            if on_card else None)
    return {"metric": "%s_examples_per_sec_per_chip" % args.model,
            "value": round(eps / n_chips, 2), "unit": "examples/s/chip",
            "n_chips": n_chips, "first_loss": round(losses[0], 5),
            "last_loss": round(losses[-1], 5)}


def main(argv=None):
    args = parse_args(argv)
    if args.model == "transformer":
        rec = run_transformer(args)
    elif args.model == "transformer_native":
        rec = run_transformer_native(args)
    else:
        rec = run_static_model(args)
        if args.update_method in ("spmd", "nccl2"):
            from .parallel.mesh import destroy_data_group

            destroy_data_group()
    if args.json:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
