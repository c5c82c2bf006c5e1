"""chip_smoke.py refuses to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return False
        except (ValueError, AttributeError):
            pass
    return True


def test_main_refuses_the_cpu_backend(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "no card, 0 W")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() != 0
    assert _no_result(capsys.readouterr().out)


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_fails_without_a_gpu():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
