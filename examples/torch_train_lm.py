"""Train the ~125M-param xlstm-125m on the PyTorch/CUDA port at reduced
sequence length with checkpoint/restart (kill it mid-run and re-invoke:
it resumes from the last committed step and replays the same data
stream), through ``repro_torch.launch.train`` with the arguments of
``examples/train_lm.py``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --smoke --steps 3 \
      --seq 32 --device cpu --ckpt /tmp/xlstm_ckpt_cpu
(full-size config on the card; --smoke for a quick CPU sanity run)
"""
import argparse

from repro_torch.launch.train import main as train_main


def launcher_argv(args) -> list[str]:
    """The launcher's arguments for parsed ``args``: the reference
    example's (batch 4 x seq 256 by default, a checkpoint every 20
    steps), with the checkpoint directory and the device."""
    argv = ["--arch", "xlstm-125m", "--steps", str(args.steps),
            "--batch", "4", "--seq", str(args.seq), "--ckpt", args.ckpt,
            "--ckpt-every", "20", "--device", args.device]
    if args.smoke:
        argv.append("--smoke")
    return argv


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", type=int, default=256,
                    help="sequence length (short for a CPU run)")
    ap.add_argument("--ckpt", default="/tmp/xlstm_ckpt",
                    help="checkpoint directory (a run there resumes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    tr = train_main(launcher_argv(parse_args(argv)))
    last = tr.metrics_log[-1] if tr.metrics_log else {}
    return {"step": last["step"] + 1 if last else None,
            "loss": last.get("loss"), "grad_norm": last.get("grad_norm"),
            "stragglers": len(tr.monitor.flagged),
            "losses": [m["loss"] for m in tr.metrics_log],
            "step_s": [m["dt"] for m in tr.metrics_log], "trainer": tr}


if __name__ == "__main__":
    main()
