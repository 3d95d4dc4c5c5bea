"""Training entry point (reference ``codes/train.py`` surface).

    python -m esrganplus_tpu_torch.cli.train -opt path/to/options.json [--device cuda|cpu]
        [--profile DIR [--profile-steps N]]

Counterpart of ``esrganplus_tpu/cli/train.py`` for PSNR pretraining
(``model: "sr"``) and GAN fine-tuning (``model: "srgan" | "srragan"``) of
an RRDBNet or SRResNet generator, and SFT-GAN (``model: "sftgan"``: the
seg-conditioned SFT_Net against the ACD discriminator, fed (LR, seg, HR,
category) by mode ``LRHRseg_bg``): experiment-dir management, dual loggers,
periodic validation with PSNR and saved val images, checkpoint/resume with
optimizer state (from a state this package or the JAX package wrote,
``train/checkpoint.py::load_state_auto``), reference-layout .pth weight export
(G and, for the GAN models, D: the ACD for SFT-GAN), optional TensorBoard
scalars. Validation runs one image at a time, or with ``"eval_sharded":
true`` batched through ``infer.BatchedEvaluator`` (SFT-GAN's seg map as its
side input). Runs on the
card (``--device cuda``, the default), an RRDBNet forward and backward
through the CUDA kernels; ``--device cpu`` runs the plain graph.

``datasets.train.resident_crops: N`` keeps N aligned crop pairs (SFT-GAN:
(LR, seg, HR, category) crops) in device
memory and samples, augments and casts each batch there
(``data/resident.py``; ``resident_refresh`` re-crops every N steps,
``resident_async_refresh`` builds the new pool in a background thread).
``train.steps_per_dispatch: K`` (an integer >= 1, resident mode only) runs up
to K resident steps per dispatch (:func:`compute_burst_len`, as the JAX
package's): on the card each step is a replay of a captured CUDA graph
(``train/resident_exec.py``; a burst of K is K replays with no host
synchronisation between them, and K = 1 is one replay a step), on the CPU
K eager calls. A step that cannot be captured raises. ``--profile DIR``
traces ``--profile-steps`` steps
from the 10th after the start with ``torch.profiler`` into DIR
(``cli/profile_summary.py`` reads it). Multi-process launch is not ported
yet and exits saying so.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _export_networks(models_dir, tag, model_kind, state, net_g, net_d, trainer):
    from esrganplus_tpu_torch.train.checkpoint import save_networks_pth

    if model_kind == "sr":
        save_networks_pth(models_dir, tag, trainer.canonical_params(state["params"]), net_g)
    else:
        save_networks_pth(models_dir, tag, trainer.canonical_params(state["g_params"]), net_g,
                          state["d_params"], net_d)


def compute_burst_len(step: int, burst: int, niter: int, freqs, prof_points) -> int:
    """Length of the next resident step burst starting at ``step``, as the
    JAX package's (``esrganplus_tpu/cli/train.py``): quantised to {burst,
    1}, so boundary remainders run as single steps; a burst never crosses a
    periodic boundary in ``freqs`` (print/val/save/refresh; 0 or None: no
    boundary), a profiler start/stop point, or ``niter``."""
    n = min(burst, niter - step)
    for f in freqs:
        if f and f > 0:
            n = min(n, f - step % f)
    for p in prof_points:
        if p is not None and step < p:
            n = min(n, p - step)
    return n if n == burst else 1


def _get_tb_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", required=True, help="path to option JSON file")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the steady-state training "
                         "loop into DIR (cli.profile_summary reads it)")
    ap.add_argument("--profile-steps", type=int, default=20,
                    help="how many steps to trace (after 10 warm-up steps)")
    ap.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process launch (not yet ported)")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    args = ap.parse_args(argv)
    if args.dist_coordinator is not None or args.dist_num_processes is not None \
            or args.dist_process_id is not None:
        ap.error("--dist-*: multi-process training is not yet ported to the PyTorch package")

    import torch

    from esrganplus_tpu_torch.data import DeviceFeeder, create_dataloader, create_dataset
    from esrganplus_tpu_torch.infer import resolve_device
    from esrganplus_tpu_torch.models.sft import SFTNetConfig
    from esrganplus_tpu_torch.ops.image_io import save_img, tensor2img
    from esrganplus_tpu_torch.ops.metrics import calculate_psnr
    from esrganplus_tpu_torch.options.options import (build_net_d_config, build_net_g_config,
                                                      build_train_config, check_resume,
                                                      dict2str, parse)
    from esrganplus_tpu_torch.train.checkpoint import (STATE_SUFFIX, AsyncCheckpointer,
                                                       load_state_auto)
    from esrganplus_tpu_torch.utils import mkdir_and_rename, set_random_seed, setup_logger

    device = resolve_device(args.device)
    opt = parse(args.opt, is_train=True)
    model_kind = opt["model"]
    net_g = build_net_g_config(opt)        # raise for what is not ported
    train_cfg = build_train_config(opt)    # before any directory is touched
    if (model_kind == "sftgan") != isinstance(net_g, SFTNetConfig):
        raise ValueError(f"model {model_kind!r} cannot train a {type(net_g).__name__}: "
                         "model 'sftgan' trains an SFT_Net (network_G.which_model_G: "
                         "sft_arch), and only it does")
    dispatch = opt["train"].get("steps_per_dispatch")
    if dispatch is not None and (isinstance(dispatch, bool) or not isinstance(dispatch, int)
                                 or dispatch < 1):
        raise ValueError(f"train.steps_per_dispatch must be an integer >= 1, got {dispatch!r}")
    # SFT-GAN's ACD has no config ("dis_acd" is fixed by the model), so
    # build_net_d_config is not asked for it, as in the JAX package
    net_d = build_net_d_config(opt) if model_kind in ("srgan", "srragan") else None
    train_opt_ds = val_opt_ds = None
    for ds_opt in opt["datasets"].values():
        if ds_opt["phase"] == "train":
            train_opt_ds = ds_opt
        elif ds_opt["phase"] == "val":
            val_opt_ds = ds_opt
    assert train_opt_ds is not None, "no train dataset in options"

    resume_path = opt["path"].get("resume_state")
    if resume_path:
        check_resume(opt)
    else:
        mkdir_and_rename(opt["path"]["experiments_root"])
    for key in ("models", "training_state", "val_images", "log"):
        os.makedirs(opt["path"][key], exist_ok=True)

    logger = setup_logger("base", opt["path"]["log"], "train", screen=True)
    logger.info(dict2str(opt))
    tb = _get_tb_writer(os.path.join(opt["path"]["log"], "tb")) \
        if (opt.get("use_tb_logger") and "debug" not in opt["name"]) else None

    seed = opt["train"].get("manual_seed") or 0
    set_random_seed(seed)

    # ---- data ----
    val_ds = create_dataset(val_opt_ds) if val_opt_ds is not None else None
    train_ds = create_dataset(train_opt_ds)
    batch_size = train_opt_ds.get("batch_size", 16)
    niter = int(opt["train"].get("niter", 500_000))
    logger.info(f"train images: {len(train_ds)}, batch {batch_size}, iters {niter:,}")

    # ---- trainer ----
    from esrganplus_tpu_torch.train import GANTrainer, SFTGANTrainer, SRTrainer

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name})")
    if model_kind == "sr":
        trainer = SRTrainer(net_g, train_cfg, device=device)
    elif model_kind == "sftgan":
        trainer = SFTGANTrainer(net_g, train_cfg, device=device)
    else:
        trainer = GANTrainer(net_g, net_d, train_cfg, device=device)
    if getattr(trainer, "use_feature", False) and not trainer.f_params.get("pretrained"):
        logger.warning("VGG19 weights not provided (path.vgg19); perceptual "
                       "loss uses RANDOM features — supply a torchvision "
                       "vgg19 .pth for real training")
    state = trainer.init_state(seed)

    # ---- pretrained / resume ----
    g_key = "params" if model_kind == "sr" else "g_params"
    if opt["path"].get("pretrain_model_G") and not resume_path:
        from esrganplus_tpu_torch.convert import generator_from_state_dict, load_state_dict

        params, _, _ = generator_from_state_dict(
            load_state_dict(opt["path"]["pretrain_model_G"]), net_g)
        state[g_key] = trainer.ingest_params(params)
        logger.info(f"loaded pretrained G from {opt['path']['pretrain_model_G']}")
    if opt["path"].get("pretrain_model_D") and not resume_path:
        # reference semantics: GAN models load a pretrained D when set
        # (SRGAN_model.py:233)
        if model_kind == "sr":
            logger.warning("pretrain_model_D is set but model 'sr' has no "
                           "discriminator — ignored")
        else:
            from esrganplus_tpu_torch.convert import (discriminator_from_state_dict,
                                                      discriminator_sn_from_state_dict,
                                                      load_state_dict)
            from esrganplus_tpu_torch.models.sft import acd_from_state_dict

            sd_d = load_state_dict(opt["path"]["pretrain_model_D"])
            if model_kind == "sftgan":  # SFTGAN_ACD_model.py:254
                d_params = acd_from_state_dict(sd_d)
            elif net_d.spectral_norm:
                d_params = discriminator_sn_from_state_dict(sd_d, net_d)
            else:
                d_params = discriminator_from_state_dict(sd_d, net_d)
            state["d_params"] = trainer.ingest_d_params(d_params)
            logger.info(f"loaded pretrained D from {opt['path']['pretrain_model_D']}")
    start_step = 0
    if resume_path:
        # also a state the JAX package's trainer wrote (its prepared-trunk
        # layout and a GAN state's f_params included)
        state = load_state_auto(resume_path, state, net_g)
        start_step = int(state["step"])
        logger.info(f"resumed from {resume_path} at step {start_step}")

    # ---- loop ----
    print_freq = opt["logger"].get("print_freq", 100)
    val_freq = opt["train"].get("val_freq", 5000)
    save_freq = opt["train"].get("save_checkpoint_freq", 5000)
    rng = seed + 1  # the run's seed for noise and sampling; the trainer folds the step in
    ckpt = AsyncCheckpointer()
    resident_n = train_opt_ds.get("resident_crops")
    sft = model_kind == "sftgan"
    train_loader = feeder_obj = store = None
    if resident_n:
        # the crop pool lives on the device; each batch is sampled there
        from esrganplus_tpu_torch.data.resident import ResidentCropStore, ResidentSegStore

        store = (ResidentSegStore if sft else ResidentCropStore)(
            train_ds, device, n_crops=int(resident_n),
            refresh_steps=int(train_opt_ds.get("resident_refresh", 1000)),
            async_refresh=bool(train_opt_ds.get("resident_async_refresh", True)),
            seed=seed, use_flip=train_opt_ds.get("use_flip", True),
            use_rot=train_opt_ds.get("use_rot", True), start_step=start_step)
        logger.info(f"resident crop store: {store.n_crops} pairs on {device} "
                    f"({store.nbytes:,} bytes), refresh every "
                    f"{store.refresh_steps} steps")
    else:
        # a resumed run continues the batch stream where the checkpoint left it
        train_loader = create_dataloader(train_ds, train_opt_ds, seed=seed,
                                         start_batch=start_step)
        feeder_obj = DeviceFeeder(train_loader, device, keys=(
            ("LR", "seg", "HR", "category") if sft else ("LR", "HR")))
        feeder = iter(feeder_obj)
    # train.steps_per_dispatch (resident mode only): up to K steps a dispatch,
    # never across a print/val/save/refresh/profile/niter boundary, so every
    # host cadence behaves as with K = 1
    burst = (dispatch or 1) if store is not None else 1
    if burst > 1:
        logger.info(f"steps_per_dispatch {burst}: resident bursts of {burst} steps")

    # --profile: trace [start+10, start+10+profile_steps), past the warm-up
    prof_start = start_step + 10 if args.profile and args.profile_steps > 0 else None
    prof_stop = prof_start + args.profile_steps if prof_start is not None else None
    prof = None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def stop_profile(why: str):
        sync()
        prof.stop()  # writes the trace through its handler
        logger.info(f"profiler trace written to {args.profile}{why}")

    def burst_len(step: int) -> int:
        return compute_burst_len(step, burst, niter,
                                 (print_freq, val_freq, save_freq,
                                  store.refresh_steps if store is not None else 0),
                                 (prof_start, prof_stop))

    def log_bursts():
        # the burst lengths since the last such line (printed with K > 1)
        if burst > 1 and bursts:
            logger.info(f"bursts: {' '.join(map(str, bursts))}")
        bursts.clear()

    bursts = []
    t_last = time.time()
    step = start_step
    while step < niter:
        if step == prof_start:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if device.type == "cuda" else [])
            sync()
            prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
                args.profile))
            prof.start()
            logger.info(f"profiler trace started -> {args.profile}")
        if store is not None:
            store.maybe_refresh(step)
            n_burst = burst_len(step)
            bursts.append(n_burst)
            state, logs = trainer.train_step_resident(state, store, rng, batch_size,
                                                      n_steps=n_burst)
            step += n_burst - 1  # the loop's tail accounts for one step
        else:
            batch_dev, _ = next(feeder)
            state, logs = trainer.train_step(state, batch_dev, rng)
        if prof is not None and step + 1 >= prof_stop:
            stop_profile("")
            prof = None

        if (step + 1) % print_freq == 0:
            logs_h = {k: float(v) for k, v in logs.items()}  # waits for the device
            dt = (time.time() - t_last) / print_freq
            t_last = time.time()
            msg = f"<step:{step + 1:8,d}, {dt*1000:6.1f} ms/it> " + " ".join(
                f"{k}: {v:.4e}" for k, v in logs_h.items())
            logger.info(msg)
            log_bursts()
            if tb:
                for k, v in logs_h.items():
                    tb.add_scalar(k, v, step + 1)

        if val_ds is not None and (step + 1) % val_freq == 0:
            psnrs = []
            scale = net_g.upscale
            samples = [val_ds[i] for i in range(len(val_ds))]
            if opt.get("eval_sharded"):
                # batched, the set edge-padded to its largest image (interior-
                # exact; see infer.BatchedEvaluator)
                from esrganplus_tpu_torch.infer import BatchedEvaluator

                evaluator = BatchedEvaluator(
                    trainer.canonical_params(state[g_key]), net_g,
                    dtype=None if sft else trainer._dtype, device=device,
                    side_scale=net_g.upscale if sft else 0)
                srs = evaluator.upscale_batch([s["LR"] for s in samples],
                                              sides=[s["seg"] for s in samples] if sft else None)
            else:  # the sequential whole-image protocol
                side = (lambda s: (s["seg"][None],)) if sft else (lambda s: ())
                srs = [trainer.predict(state[g_key], s["LR"][None], *side(s))[0].cpu().numpy()
                       for s in samples]
            for sample, sr in zip(samples, srs):
                sr_img = tensor2img(sr)
                gt_img = tensor2img(sample["HR"])
                base = os.path.splitext(os.path.basename(sample["HR_path"]))[0]
                img_dir = os.path.join(opt["path"]["val_images"], base)
                os.makedirs(img_dir, exist_ok=True)
                save_img(sr_img, os.path.join(img_dir, f"{base}_{step + 1}.png"))
                c = scale
                psnrs.append(calculate_psnr(
                    sr_img[c:-c, c:-c].astype(np.float64),
                    gt_img[c:-c, c:-c].astype(np.float64)))
            mean_psnr = float(np.mean(psnrs))
            logger.info(f"# Validation # PSNR: {mean_psnr:.4e}")
            if tb:
                tb.add_scalar("val_psnr", mean_psnr, step + 1)

        if (step + 1) % save_freq == 0:
            logger.info("Saving models and training states.")
            tag = step + 1
            # async: snapshot on the device now, fetch+write in the background
            ckpt.save(
                os.path.join(opt["path"]["training_state"], f"{tag}{STATE_SUFFIX}"),
                state,
                export_fn=lambda snap, tag=tag: _export_networks(
                    opt["path"]["models"], tag, model_kind, snap, net_g, net_d, trainer))
        step += 1

    log_bursts()
    if trainer._resident is not None:  # the captured steps (on the card)
        logger.info(f"resident step graphs: {trainer._resident.captures} captured in "
                    f"{trainer._resident.capture_seconds:.2f} s")
    if prof is not None:
        # the window reached past niter: close it so the trace is written
        stop_profile(" (the run ended inside the profile window)")
    ckpt.wait()  # flush any in-flight periodic save before the final one
    logger.info("Saving the final model.")
    _export_networks(opt["path"]["models"], "latest", model_kind, state, net_g, net_d, trainer)
    logger.info("End of training.")
    if feeder_obj is not None:
        feeder_obj.stop()
        train_loader.stop()


if __name__ == "__main__":
    main()
