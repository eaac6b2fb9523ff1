"""Training supervisor: stall detection and restart with ``--resume``
(scripts/train_supervisor.py for the port).

It runs a training command as a child process, with its output appended to
``--supervisor_log``, and watches that file. When the file has not grown
for ``--stall_secs`` the child's process group is killed; when the child
exits with an error or was killed, it is started again with ``--resume
<newest checkpoint under --logdir>`` (``<logdir>/*/checkpoints/*.ckpt``,
the newest by modification time), at most ``--max_restarts`` times.
``--resume_latest`` adds that resume to the first launch too.

  python -m moldiff_tpu_torch.train.supervisor --stall_secs 600 --max_restarts 5 -- \\
      -m moldiff_tpu_torch.train --config configs/train/train_v2_cont.yml \\
      --logdir ./logs_torch --reset_ema --reset_optim

The command after ``--`` is a Python script (``path.py ...``) or a module
(``-m name ...``), run with this interpreter. A step that hangs on the
card stops writing the log; ``--max_iters`` is absolute, so a resumed
command ends where the first would have. As in the JAX script, a command
that carries its own ``--resume`` is restarted with it unchanged (and with
any ``--reset_ema`` / ``--reset_optim`` again): start a fine-tuning run
from its checkpoint once, then supervise its continuation with
``--resume_latest`` and a command without those flags.
"""
from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

DEFAULT_LOGDIR = "./logs_torch"
POLL_SECS = 10  # how often the log is read; a restart waits half of it


def newest_checkpoint(logdir: str) -> Optional[str]:
    ckpts = glob.glob(os.path.join(logdir, "*", "checkpoints", "*.ckpt"))
    if not ckpts:
        return None
    return max(ckpts, key=os.path.getmtime)


def run_once(cmd: List[str], log_path: str, stall_secs: float) -> int:
    """Run the child; its exit code, or -1 when it was killed for not
    writing its log for ``stall_secs``."""
    with open(log_path, "ab") as logf:
        child = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                 start_new_session=True)
        last_size = -1
        last_progress = time.time()
        while True:
            rc = child.poll()
            if rc is not None:
                return rc
            time.sleep(POLL_SECS)
            try:
                size = os.path.getsize(log_path)
            except OSError:
                size = -1
            if size != last_size:
                last_size = size
                last_progress = time.time()
            elif time.time() - last_progress > stall_secs:
                print(f"[supervisor] no log progress for {stall_secs}s; "
                      f"killing pid {child.pid}", flush=True)
                os.killpg(os.getpgid(child.pid), signal.SIGKILL)
                child.wait()
                return -1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stall_secs", type=float, default=600)
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--supervisor_log", default="supervisor.log")
    ap.add_argument("--resume_latest", action="store_true",
                    help="add --resume <newest checkpoint> to the first launch too "
                         "(picking up a run the supervisor did not start)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- then the training command (script.py or -m module, and its "
                         "arguments)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        raise SystemExit("pass the training command after --")
    if not (cmd[0].endswith(".py") or (cmd[0] == "-m" and len(cmd) > 1)):
        raise SystemExit(f"expected a python script or -m module, got {cmd[0]}")
    logdir = DEFAULT_LOGDIR
    for i, c in enumerate(cmd[:-1]):
        if c == "--logdir":
            logdir = cmd[i + 1]

    restarts = 0
    while True:
        full = [sys.executable] + cmd
        ckpt = newest_checkpoint(logdir)
        if (restarts > 0 or args.resume_latest) and ckpt and "--resume" not in full:
            full += ["--resume", ckpt]
            print(f"[supervisor] resuming from {ckpt}", flush=True)
        rc = run_once(full, args.supervisor_log, args.stall_secs)
        if rc == 0:
            print("[supervisor] training finished", flush=True)
            return 0
        restarts += 1
        print(f"[supervisor] child exited rc={rc}; restart {restarts}/{args.max_restarts}",
              flush=True)
        if restarts >= args.max_restarts:
            print("[supervisor] giving up", flush=True)
            return 1
        time.sleep(POLL_SECS / 2)


if __name__ == "__main__":
    raise SystemExit(main())
