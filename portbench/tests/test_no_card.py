"""Without a card the harness refuses to run and prints no result; it
never falls back to the CPU."""

import subprocess
import sys

from portbench import harness


def test_main_refuses_without_a_card(monkeypatch, capsys):
  import torch
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  rc = harness.main(["--workload", "tfpp.eval", "--seed", "2147483999",
                     "--seconds", "1", "--trace", "0"], 0.0)
  out = capsys.readouterr()
  assert rc != 0
  assert out.out == ""
  assert "is_available() is False" in out.err


def test_too_few_cards(monkeypatch):
  import torch
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
  try:
    harness.require_cards(1)
  except harness.HarnessError as e:
    assert "1 cards" in str(e)
  else:
    raise AssertionError("no error")


def test_command_line_without_a_card():
  """The command itself, in a fresh process, here where no card is."""
  proc = subprocess.run(
      [sys.executable, "-m", "portbench.run", "--workload", "plant.eval",
       "--seed", "3", "--seconds", "1", "--trace", "0"],
      cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
      env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(harness.ROOT)})
  assert proc.returncode != 0
  assert proc.stdout.strip() == ""
