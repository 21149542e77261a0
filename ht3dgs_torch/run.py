"""Command-line entry point of the port, the counterpart of the root
`run.py`:

    python -m ht3dgs_torch --mode {train,pose_only,eval_pose,eval_nvs,render} \
                           --config configs/tanks/Francis.yml [--flag value ...]

Modes:
  train      hierarchical training (train_level=0 trains one segment)
  pose_only  Phase A only: relative-pose chain -> pose/pose.npz
  eval_pose  ATE/RPE against the dataset's ground-truth poses
  eval_nvs   test-time pose optimization + PSNR/SSIM/LPIPS
  render     novel-trajectory video from a checkpoint

Everything runs on the card unless `main` is called with device="cpu".
With --distributed (under `torchrun --nproc-per-node N -m ht3dgs_torch
--distributed ...`) every rank trains on cuda:LOCAL_RANK over NCCL, which
needs one card per rank; the (segment, tile) mesh is pipe.mesh_segments x
pipe.mesh_tiles ranks.
"""

import contextlib
import sys
import time


def main(argv=None, device="cuda"):
    from .train.hierarchy import HTGaussianTrainer
    from .utils.config import configs_from_cli
    from .utils.profiling import torch_trace, tracing

    model, pipe, optim, args = configs_from_cli(argv)
    rank = 0
    if getattr(pipe, "distributed", False):
        # torch.distributed first (torchrun's environment): every rank runs
        # this program on its own device, cuda:LOCAL_RANK, NCCL on cards
        from .parallel import mesh

        n = mesh.init_distributed(device=device)
        device, rank = mesh.rank_device(device), mesh.rank()
        print(f"[distributed] process {rank}/{n} on {device}")
    if rank != 0 and args.mode in ("eval_pose", "eval_nvs", "render"):
        return      # the eval modes run on rank 0 alone
    start = time.time()

    trainer = HTGaussianTrainer(model.source_path, model, pipe, optim,
                                device=device)
    # with a trace directory, the port's spans show in the trace
    spans = tracing() if pipe.trace_dir else contextlib.nullcontext()
    with torch_trace(pipe.trace_dir), spans:
        if args.mode == "train":
            trainer.hierarchical_training()
        elif args.mode == "pose_only":
            trainer.train_pose_only()
        elif args.mode == "eval_pose":
            trainer.eval_pose()
        elif args.mode == "eval_nvs":
            trainer.eval_nvs()
        elif args.mode == "render":
            trainer.render_nvs(traj_opt=model.traj_opt)
        else:
            raise SystemExit(f"unknown mode {args.mode}")

    dt = time.time() - start
    print(f"[{args.mode}] finished in {dt / 60:.1f} min")


if __name__ == "__main__":
    main(sys.argv[1:])
