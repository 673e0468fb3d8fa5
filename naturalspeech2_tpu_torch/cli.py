"""Command-line interface of the port (`naturalspeech2_tpu/cli.py`'s
counterpart): train / sample / codec-train / serve / import-torch / info.

    ns2-torch train        --folder wavs/ --steps 100000 --results results/
    ns2-torch sample       --checkpoint results/model-7.ckpt --out out/
    ns2-torch codec-train  --folder wavs/ --steps 50000 --adversarial-weight 1
    ns2-torch serve        --checkpoint results/model-7.ckpt --config cfg.json
    ns2-torch import-torch --input ref.pt --output ns2.ckpt [--encodec]
    ns2-torch info         --config cfg.json

``train``, ``sample``, ``codec-train`` and ``serve`` take ``--device``
(``cuda`` by default; without a card they raise rather than fall back to
the CPU; ``--device cpu`` runs the plain PyTorch versions of the kernels);
``info`` and ``import-torch`` do no device work.

``train --mesh-data N [--param-sharding fsdp]`` and ``codec-train
--mesh-data N`` train data-parallel over N ranks: under ``torchrun``
(``WORLD_SIZE`` must be N) each process joins its group; started alone,
the command starts N workers, one per card (NCCL), or on the CPU over
gloo with ``--device cpu``:

    torchrun --nproc-per-node 2 -m naturalspeech2_tpu_torch train --mesh-data 2 ...
    ns2-torch train --mesh-data 2 --param-sharding fsdp --folder wavs/ ...

``serve --tp N`` serves tensor-parallel over N ranks in the same way
(under ``torchrun``, or N workers it starts): rank 0 runs the HTTP server
and the batcher, the other ranks follow its device calls
(`serve.TTSEngine.follow`).

Model architecture comes from a JSON config file (``--config``) with
sections mapping 1:1 onto the constructors — the same kwargs the Python API
and the JAX package's CLI take:

    {"codec":   {"type": "soundstream"},            # or {"type": "encodec"}
     "model":   {"dim": 128, "depth": 6},
     "ns2":     {"timesteps": 1000},
     "trainer": {"train_batch_size": 16}}

Omitted sections fall back to the flagship defaults (the reference
README's canonical unconditional config).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from naturalspeech2_tpu_torch.serve import resolve_device


# --------------------------------------------------------------------- #
# config → model objects
# --------------------------------------------------------------------- #

FLAGSHIP = {
    "codec": {"type": "soundstream"},
    "model": {"dim": 128, "depth": 6, "scan_layers": True},
    "ns2": {"timesteps": 1000},
    "trainer": {},
}


def load_config(path: Optional[str]) -> Dict[str, Any]:
    cfg = {k: dict(v) for k, v in FLAGSHIP.items()}
    if path is not None:
        user = json.loads(Path(path).read_text())
        for section, values in user.items():
            assert section in cfg, (
                f"unknown config section {section!r} "
                f"(expected one of {sorted(cfg)})"
            )
            cfg[section].update(values)
    return cfg


def build_codec(codec_cfg: Dict[str, Any]):
    cfg = dict(codec_cfg)
    kind = cfg.pop("type", "soundstream")
    if kind == "soundstream":
        from naturalspeech2_tpu_torch.models.codec import SoundStream

        return SoundStream(**cfg)
    if kind == "encodec":
        from naturalspeech2_tpu_torch.models.encodec import Encodec

        return Encodec(**cfg)
    raise ValueError(f"codec type must be soundstream|encodec, got {kind!r}")


def build_ns2(cfg: Dict[str, Any]):
    """The config's `NaturalSpeech2` on the CPU, with ``Tokenizer()`` unless
    the ``ns2`` section names another."""
    from naturalspeech2_tpu_torch.models.denoiser import Model
    from naturalspeech2_tpu_torch.models.naturalspeech2 import NaturalSpeech2
    from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer

    codec = build_codec(cfg["codec"])
    model = Model(**cfg["model"])
    ns2_kwargs = dict(cfg["ns2"])
    ns2_kwargs.setdefault("tokenizer", Tokenizer())
    return NaturalSpeech2(model=model, codec=codec, **ns2_kwargs)


# --------------------------------------------------------------------- #
# checkpoint loading for inference
# --------------------------------------------------------------------- #


def _state(checkpoint: str) -> tuple[dict, dict]:
    """(the checkpoint's payload, its parameters as a state dict)."""
    import torch

    payload = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return payload, dict(payload["params"]) if "params" in payload else dict(payload)


def load_for_inference(ns2, checkpoint: str, *, use_ema: bool = True,
                       codec_checkpoint: Optional[str] = None):
    """Load a port checkpoint into ``ns2`` and return it.

    Accepts the `Trainer`'s ``torch.save`` files ({step, params, opt_state,
    ema_params, version}), ``import-torch``'s ({params, version}) and bare
    state dicts. Prefers the EMA weights (the reference samples from its EMA
    copy). ``codec_checkpoint`` (a `CodecTrainer` checkpoint or ``import-torch
    --encodec``'s) supplies the codec's weights, which an imported reference
    checkpoint lacks; every parameter must then be covered (``strict``)."""
    payload, state = _state(checkpoint)
    if use_ema and "ema_params" in payload:
        state.update(payload["ema_params"])
    if codec_checkpoint is not None:
        state.update({f"codec.{k}": v for k, v in _state(codec_checkpoint)[1].items()})
    ns2.load_state_dict(state, strict=True)
    return ns2


# --------------------------------------------------------------------- #
# subcommands
# --------------------------------------------------------------------- #


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank(args, body, rank: int, world: int, local: int, init_method: str,
          n_model: int = 1) -> int:
    """One rank: join the group (NCCL on card ``local``, gloo on the CPU),
    run ``body(args, mesh)`` on a mesh of ``n_model`` model ranks, leave
    the group."""
    import torch
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    if torch.device(args.device).type == "cuda":
        device, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        return body(args, make_mesh(n_data=world // n_model, n_model=n_model, device=device))
    finally:
        dist.destroy_process_group()


def _spawned_rank(rank: int, args, body, world: int, init_method: str, n_model: int) -> None:
    _rank(args, body, rank, world, rank, init_method, n_model)


def _ranks(args, body, n: int, flag: str, n_model: int = 1) -> int:
    """``body(args, mesh)`` on each of ``n`` ranks (``flag`` is the option
    that asked for them), ``n_model`` of them on the model axis. Under
    torchrun the process joins its group; otherwise the ranks are started
    here, and a rank's failure ends the others and raises."""
    import torch

    if n < 1:
        raise ValueError(f"{flag} must be at least 1, got {n}")
    world = os.environ.get("WORLD_SIZE")
    if world is not None:  # started by torchrun: join its group
        if int(world) != n:
            raise ValueError(f"{flag} {n} does not match WORLD_SIZE={world} (the "
                             "launcher's process count)")
        rank = int(os.environ["RANK"])
        return _rank(args, body, rank, n, int(os.environ.get("LOCAL_RANK", rank)), "env://",
                     n_model)
    if torch.device(args.device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{flag} {n} asks for {n} cards; this host has "
                           f"{torch.cuda.device_count()}")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    if n == 1:
        return _rank(args, body, 0, 1, 0, init_method, n_model)
    workers = torch.multiprocessing.start_processes(
        _spawned_rank, args=(args, body, n, init_method, n_model), nprocs=n, join=False,
        start_method="spawn")
    while True:
        try:
            if workers.join():
                return 0
        except KeyboardInterrupt:  # the ranks got it too, and stop by themselves
            continue


def _data_parallel(args, body) -> int:
    """``body(args, mesh)`` on each rank of a data mesh of ``--mesh-data``
    ranks, or ``body(args, None)`` without the flag."""
    if args.mesh_data is None:
        return body(args, None)
    return _ranks(args, body, args.mesh_data, "--mesh-data")


def _train_kwargs(args) -> Dict[str, Any]:
    tr_kwargs: Dict[str, Any] = dict(load_config(args.config)["trainer"])
    for name, value in [
        ("train_batch_size", args.batch_size),
        ("grad_accum_every", args.grad_accum),
        ("lr", args.lr),
        ("train_num_steps", args.steps),
        ("save_and_sample_every", args.save_every),
        ("results_folder", args.results),
        ("amp", args.amp or None),
        ("steps_per_dispatch", args.steps_per_dispatch),
        ("data_max_length_seconds", args.data_seconds),
        ("checkpoint_backend", args.checkpoint_backend),
        ("param_sharding", args.param_sharding),
        ("skip_nonfinite_updates", args.skip_nonfinite or None),
        ("lr_schedule", args.lr_schedule),
        ("warmup_steps", args.warmup_steps),
        ("val_fraction", args.val_fraction),
        ("validate_every", args.validate_every),
    ]:
        if value is not None:
            tr_kwargs[name] = value
    return tr_kwargs


def cmd_train(args) -> int:
    from naturalspeech2_tpu_torch.parallel import check_batch_split

    batch = _train_kwargs(args).get("train_batch_size")
    if args.mesh_data is not None and batch is not None:  # refuse before any rank starts
        check_batch_split(batch, args.mesh_data)
    return _data_parallel(args, _train)


def _train(args, mesh) -> int:
    import torch

    from naturalspeech2_tpu_torch.trainer import Trainer

    device = mesh.device if mesh is not None else resolve_device(args.device)
    torch.manual_seed(args.seed)
    ns2 = build_ns2(load_config(args.config)).to(device)
    trainer = Trainer(ns2, folder=args.folder, mesh=mesh, **_train_kwargs(args))
    trainer.train(log_every=args.log_every)
    return 0


def cmd_codec_train(args) -> int:
    from naturalspeech2_tpu_torch.parallel import check_batch_split

    if args.mesh_data is not None:  # refuse before any rank starts
        check_batch_split(args.batch_size, args.mesh_data)
    return _data_parallel(args, _codec_train)


def _codec_train(args, mesh) -> int:
    import torch

    from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer
    from naturalspeech2_tpu_torch.data import SoundDataset, data_loader

    device = mesh.device if mesh is not None else resolve_device(args.device)
    torch.manual_seed(args.seed)
    codec = build_codec(load_config(args.config)["codec"]).to(device)
    dataset = SoundDataset(args.folder, max_length=int(args.data_seconds * codec.target_sample_hz),
                           target_sample_hz=codec.target_sample_hz,
                           seq_len_multiple_of=codec.seq_len_multiple_of)
    trainer = CodecTrainer(
        codec,
        batches=data_loader(dataset, args.batch_size, seed=args.seed),
        lr=args.lr if args.lr is not None else 3e-4,
        adversarial_weight=args.adversarial_weight,
        adversarial_warmup=args.warmup,
        amp=bool(args.amp),
        mesh=mesh,
        results_folder=args.results,
        seed=args.seed,
    )
    if args.resume is not None:
        trainer.load(args.resume)
    # in save_every-sized segments: a resumable checkpoint after each
    start = 0 if trainer.state is None else trainer.state.step
    while start < args.steps:
        trainer.train(min(start + args.save_every, args.steps), log_every=args.log_every,
                      steps_per_jit=args.steps_per_dispatch or 8)
        start = trainer.state.step
        path = trainer.save(start)
        if path:
            print(path)
    return 0


def cmd_sample(args) -> int:
    import torch

    from naturalspeech2_tpu_torch.data import load_audio, resample, write_wav
    from naturalspeech2_tpu_torch.models.naturalspeech2 import sample

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.sampler is not None:
        cfg["ns2"]["sampler"] = args.sampler
    ns2 = build_ns2(cfg)
    load_for_inference(ns2, args.checkpoint, use_ema=not args.no_ema,
                       codec_checkpoint=args.codec_checkpoint)
    ns2.to(device)

    kwargs: Dict[str, Any] = {}
    if ns2.conditional:
        assert args.text and args.prompt, (
            "conditional model: pass --text and --prompt <wav>"
        )
        prompt_audio, sr = load_audio(args.prompt)
        prompt_audio = resample(prompt_audio, sr, ns2.sample_hz)
        texts = list(args.text)
        # one prompt voice, N texts: tile to the text batch
        kwargs["prompt"] = torch.from_numpy(np.ascontiguousarray(prompt_audio)).to(
            device)[None, :].repeat(len(texts), 1)
        kwargs["text"] = texts
        kwargs["cond_scale"] = args.cond_scale
        kwargs["cfg_rescale"] = args.cfg_rescale
        if args.cfg_interval is not None:
            kwargs["cfg_interval"] = tuple(args.cfg_interval)
    else:
        kwargs["batch_size"] = args.batch

    length = args.length
    if args.seconds is not None:
        hop = ns2.codec.seq_len_multiple_of if ns2.codec is not None else 320
        length = int(round(args.seconds * ns2.sample_hz / hop))

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    audio = sample(
        ns2,
        length=length,
        timesteps=args.timesteps,
        generator=torch.Generator(device).manual_seed(args.seed),
        dtype=torch.bfloat16 if args.bf16 else None,
        **kwargs,
    )
    audio = audio.cpu().numpy()
    for i in range(audio.shape[0]):
        path = out_dir / f"sample-{i}.wav"
        write_wav(path, audio[i], ns2.sample_hz)
        print(path)
    return 0


def build_engine(
    config: Optional[str],
    checkpoint: str,
    *,
    timesteps: Optional[int] = None,
    cond_scale: float = 3.0,
    tp: int = 1,
    device: Optional[str] = None,
    codec_checkpoint: Optional[str] = None,
    **engine_kwargs,
):
    """checkpoint + config → a ready `TTSEngine` on ``device`` (``None``:
    the card) — the `serve` glue, separated so it is testable without a
    blocking HTTP server. ``tp`` > 1 serves tensor-parallel: call it on
    each of ``tp`` ranks of an initialised process group (``serve --tp``
    starts them)."""
    from naturalspeech2_tpu_torch import serve as serve_mod
    from naturalspeech2_tpu_torch.parallel import make_mesh

    device = resolve_device(device)
    mesh = None
    if tp > 1:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(f"build_engine(tp={tp}) runs on each of {tp} ranks of an "
                             "initialised process group (serve --tp starts them)")
        mesh = make_mesh(n_data=1, n_model=tp, device=device)
    cfg = load_config(config)
    ns2 = build_ns2(cfg)
    assert ns2.conditional, (
        "serving is text→speech: the config must enable prompt "
        "conditioning (model.condition_on_prompt)"
    )
    load_for_inference(ns2, checkpoint, codec_checkpoint=codec_checkpoint)
    return serve_mod.TTSEngine(
        ns2,
        timesteps=timesteps or 100,
        cond_scale=cond_scale,
        device=str(device),
        mesh=mesh,
        **engine_kwargs,
    )


def cmd_serve(args) -> int:
    if args.tp > 1:
        if args.demo:
            raise ValueError("--tp serves a --checkpoint, not the --demo model")
        return _ranks(args, _serve, args.tp, "--tp", n_model=args.tp)
    return _serve(args, None)


def _serve(args, mesh) -> int:
    from naturalspeech2_tpu_torch import serve as serve_mod

    if args.demo:
        engine = serve_mod._demo_engine(args.device)
    else:
        assert args.checkpoint is not None, "pass --checkpoint (or --demo)"
        engine = build_engine(
            args.config,
            args.checkpoint,
            timesteps=args.timesteps,
            cond_scale=args.cond_scale,
            tp=args.tp,
            device=str(mesh.device) if mesh is not None else args.device,
            codec_checkpoint=args.codec_checkpoint,
            dtype="bfloat16" if args.bf16 else None,
            cfg_interval=tuple(args.cfg_interval)
            if args.cfg_interval is not None else None,
        )
    if mesh is not None and not mesh.is_main:
        # rank 0's device calls, until it stops: an interrupt is rank 0's to
        # handle, and ends this rank through its stop
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        engine.follow()
        return 0
    try:
        if not args.no_warmup:
            print("warming serving buckets...", flush=True)
            print("warm:", engine.warmup(), flush=True)
        server = serve_mod.TTSServer(engine, (args.host, args.port))
        engine.start_batcher()
        print(f"serving on http://{args.host}:{server.port}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            engine.stop_batcher()
            server.server_close()
    finally:
        engine.stop_followers()
    return 0


def cmd_info(args) -> int:
    """Model summary: per-module parameter counts, codec framing, and the
    serving-relevant numbers (hop, sample rate, frames/sec)."""
    cfg = load_config(args.config)
    ns2 = build_ns2(cfg)
    hop = ns2.codec.seq_len_multiple_of if ns2.codec is not None else 320
    counts = {name: sum(p.numel() for p in child.parameters())
              for name, child in ns2.named_children()}
    counts = {name: n for name, n in counts.items() if n}
    total = sum(counts.values())
    print(f"model: {type(ns2.model).__name__} dim={ns2.dim} "
          f"conditional={ns2.conditional} sampler={ns2.sampler_name} "
          f"timesteps={ns2.timesteps}")
    print(f"codec: hop={hop} sample_hz={ns2.sample_hz} "
          f"({ns2.sample_hz / hop:.1f} latent frames/sec)")
    for name in sorted(counts):
        n = counts[name]
        print(f"  {name:<16} {n:>12,}  ({100 * n / total:.1f}%)")
    print(f"  {'TOTAL':<16} {total:>12,}")
    return 0


def cmd_import_torch(args) -> int:
    """A reference `NaturalSpeech2` checkpoint (or, with ``--encodec``, a
    HuggingFace `EncodecModel` state dict) → a port checkpoint ``{params,
    version}`` that `load_for_inference` (for an Encodec, via
    ``--codec-checkpoint``) and ``load_state_dict`` read."""
    import torch

    from naturalspeech2_tpu_torch.params import load_jax_params
    from naturalspeech2_tpu_torch.utils import torch_import as ti
    from naturalspeech2_tpu_torch.version import __version__

    sd = ti.load_torch_checkpoint(args.input)
    if args.encodec:
        tree = ti.encodec_params_from_hf(sd)
    else:
        tree = ti.naturalspeech2_params_from_torch(sd)
    state = load_jax_params(tree)
    torch.save({"params": state, "version": __version__}, args.output)
    print(f"wrote {args.output} ({len(state)} tensors)")
    return 0


# --------------------------------------------------------------------- #
# argument parsing
# --------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ns2-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", help="JSON model/trainer config file")
        sp.add_argument("--seed", type=int, default=0)

    def on_device(sp):
        common(sp)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")

    t = sub.add_parser("train", help="train a NaturalSpeech2 model")
    on_device(t)
    t.add_argument("--folder", required=True, help="folder of audio files")
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--grad-accum", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--save-every", type=int, default=None)
    t.add_argument("--results", default=None)
    t.add_argument("--amp", action="store_true", help="bfloat16 training")
    t.add_argument("--steps-per-dispatch", type=int, default=None)
    t.add_argument("--data-seconds", type=float, default=None)
    t.add_argument("--checkpoint-backend", choices=("torch", "orbax"), default=None)
    t.add_argument("--param-sharding", choices=("tp", "fsdp", "replicated"),
                   default=None)
    t.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel ranks (one per card, or CPU processes with --device cpu)")
    t.add_argument("--skip-nonfinite", action="store_true",
                   help="skip (don't apply) updates with non-finite grads")
    t.add_argument("--lr-schedule", choices=("cosine", "linear"),
                   default=None, help="default: constant lr")
    t.add_argument("--warmup-steps", type=int, default=None)
    t.add_argument("--val-fraction", type=float, default=None,
                   help="hold out this fraction of files for val_loss")
    t.add_argument("--validate-every", type=int, default=None)
    t.add_argument("--log-every", type=int, default=50)
    t.set_defaults(fn=cmd_train)

    c = sub.add_parser("codec-train", help="train the neural codec")
    on_device(c)
    c.add_argument("--folder", required=True)
    c.add_argument("--steps", type=int, default=50_000)
    c.add_argument("--batch-size", type=int, default=16)
    c.add_argument("--lr", type=float, default=None)
    c.add_argument("--data-seconds", type=float, default=0.4)
    c.add_argument("--adversarial-weight", type=float, default=0.0)
    c.add_argument("--warmup", type=int, default=0,
                   help="steps before the adversarial terms switch on")
    c.add_argument("--amp", action="store_true", help="bfloat16 codec compute")
    c.add_argument("--results", default="./results_codec")
    c.add_argument("--resume", default=None, help="checkpoint to resume from")
    c.add_argument("--save-every", type=int, default=5000)
    c.add_argument("--steps-per-dispatch", type=int, default=None)
    c.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel ranks (one per card, or CPU processes with --device cpu)")
    c.add_argument("--log-every", type=int, default=50)
    c.set_defaults(fn=cmd_codec_train)

    s = sub.add_parser("sample", help="generate audio from a checkpoint")
    on_device(s)
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--codec-checkpoint", default=None,
                   help="codec weights for a checkpoint that lacks them (import-torch)")
    s.add_argument("--out", default="./samples")
    s.add_argument("--length", type=int, default=1024,
                   help="latent frames (320 samples each at 24 kHz)")
    s.add_argument("--seconds", type=float, default=None,
                   help="output duration (overrides --length)")
    s.add_argument("--timesteps", type=int, default=None)
    s.add_argument("--sampler", choices=("ddim", "ddpm", "dpmpp"), default=None)
    s.add_argument("--batch", type=int, default=1)
    s.add_argument("--no-ema", action="store_true",
                   help="sample raw params instead of the EMA copy")
    s.add_argument("--text", action="append", default=None,
                   help="(conditional) text to speak; repeatable")
    s.add_argument("--prompt", default=None,
                   help="(conditional) prompt wav for voice conditioning")
    s.add_argument("--cond-scale", type=float, default=3.0)
    s.add_argument("--cfg-rescale", type=float, default=0.0,
                   help="std-matching CFG rescale phi in [0,1]")
    s.add_argument("--cfg-interval", type=float, nargs=2, default=None,
                   metavar=("T_LO", "T_HI"),
                   help="apply guidance only at diffusion times in [T_LO, T_HI]")
    s.add_argument("--bf16", action="store_true", help="run the denoiser in bfloat16")
    s.set_defaults(fn=cmd_sample)

    v = sub.add_parser("serve", help="HTTP TTS endpoint")
    on_device(v)
    v.add_argument("--demo", action="store_true",
                   help="tiny random model (plumbing demo)")
    v.add_argument("--checkpoint", default=None)
    v.add_argument("--codec-checkpoint", default=None,
                   help="codec weights for a checkpoint that lacks them (import-torch)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--timesteps", type=int, default=None)
    v.add_argument("--cond-scale", type=float, default=3.0)
    v.add_argument("--no-warmup", action="store_true",
                   help="build kernels and layouts on the first request")
    v.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel serving over N ranks, one card each (gloo ranks "
                        "on the CPU with --device cpu)")
    v.add_argument("--bf16", action="store_true", help="run the denoiser in bfloat16")
    v.add_argument("--cfg-interval", type=float, nargs=2, default=None,
                   metavar=("T_LO", "T_HI"),
                   help="limited-interval CFG: guidance only at diffusion "
                        "times in [T_LO, T_HI]")
    v.set_defaults(fn=cmd_serve)

    n = sub.add_parser("info", help="model summary for a config")
    common(n)
    n.set_defaults(fn=cmd_info)

    i = sub.add_parser("import-torch", help="convert a reference torch checkpoint")
    i.add_argument("--input", required=True)
    i.add_argument("--output", required=True)
    i.add_argument("--encodec", action="store_true",
                   help="input is a HuggingFace EncodecModel state dict")
    i.set_defaults(fn=cmd_import_torch)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
