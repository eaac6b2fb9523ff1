"""The port's training supervisor (moldiff_tpu_torch/train/supervisor.py) on
tests/test_supervisor.py's cases: a stalled child is killed and relaunched
with --resume from the newest checkpoint; --resume_latest adds the resume
to the first launch. A fake train script stands in for the CLI and runs as
a real child process; the supervisor runs in the test's process with its
log poll set to half a second, so each cycle takes seconds."""
import pytest

from moldiff_tpu_torch.train import supervisor

# Launch 1: writes a checkpoint, prints once, then goes silent (stall).
# Launch 2+: exits 0 at once. Every launch appends its argv to launches.txt.
_FAKE_TRAIN = r"""
import os, sys, time
args = sys.argv[1:]
logdir = args[args.index("--logdir") + 1]
os.makedirs(logdir, exist_ok=True)
marker = os.path.join(logdir, "launches.txt")
with open(marker, "a") as f:
    f.write(" ".join(args) + "\n")
n = len(open(marker).read().splitlines())
ckdir = os.path.join(logdir, "run", "checkpoints")
os.makedirs(ckdir, exist_ok=True)
with open(os.path.join(ckdir, f"{n * 1000}.ckpt"), "w") as f:
    f.write("x")
if n == 1:
    print("step 1", flush=True)
    time.sleep(600)
print("done", flush=True)
"""


@pytest.fixture
def fast_poll(monkeypatch):
    monkeypatch.setattr(supervisor, "POLL_SECS", 0.5)


def _run_supervisor(tmp_path, extra_args, fake_args):
    fake = tmp_path / "fake_train.py"
    fake.write_text(_FAKE_TRAIN)
    return supervisor.main(["--stall_secs", "5", "--max_restarts", "3",
                            "--supervisor_log", str(tmp_path / "sup.log"), *extra_args,
                            "--", str(fake), *fake_args])


def test_stall_kill_and_resume(tmp_path, fast_poll, capsys):
    logdir = tmp_path / "logs"
    rc = _run_supervisor(tmp_path, [], ["--logdir", str(logdir)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "killing pid" in out and "training finished" in out, out
    launches = (logdir / "launches.txt").read_text().splitlines()
    assert len(launches) == 2
    assert "--resume" not in launches[0]
    assert "--resume" in launches[1] and "1000.ckpt" in launches[1]
    assert "step 1" in (tmp_path / "sup.log").read_text()


def test_resume_latest_injects_on_first_launch(tmp_path, fast_poll, capsys):
    logdir = tmp_path / "logs"
    ckdir = logdir / "old_run" / "checkpoints"
    ckdir.mkdir(parents=True)
    (ckdir / "7000.ckpt").write_text("x")
    rc = _run_supervisor(tmp_path, ["--resume_latest"], ["--logdir", str(logdir)])
    assert rc == 0, capsys.readouterr().out
    launches = (logdir / "launches.txt").read_text().splitlines()
    assert "--resume" in launches[0] and "7000.ckpt" in launches[0]


def test_gives_up_after_max_restarts(tmp_path, monkeypatch, capsys):
    """A child that fails every time is restarted max_restarts - 1 times,
    then the supervisor exits 1."""
    monkeypatch.setattr(supervisor, "POLL_SECS", 0.2)
    fail = tmp_path / "fail.py"
    fail.write_text("import sys; print('boom', flush=True); sys.exit(3)\n")
    rc = supervisor.main(["--max_restarts", "2", "--supervisor_log", str(tmp_path / "sup.log"),
                          "--", str(fail)])
    out = capsys.readouterr().out
    assert rc == 1 and "giving up" in out, out
    assert (tmp_path / "sup.log").read_text().count("boom") == 2


@pytest.mark.parametrize("cmd", [[], ["--"], ["--", "train"], ["--", "-m"]])
def test_refuses_a_command_it_cannot_run(cmd):
    with pytest.raises(SystemExit):
        supervisor.main(cmd)
