"""Build and start the C++ bridge of ``bridge/`` (the 500 Hz LCM bridge,
``go1_bridge.cpp``; with no vendor SDK it drives the in-process loopback
robot of ``robot_link.hpp``).

The bridge is built at first use, as its ``CMakeLists.txt`` says (cmake,
then make, Release), into ``bridge/build/``, from the sources in this
package only; a failed build raises with the compiler's output.  The
process reads the bus from ``LCM_DEFAULT_URL`` as the python side does
(``lcm_lite.default_url``).
"""

from __future__ import annotations

import os
import subprocess

BRIDGE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bridge")
BUILD_DIR = os.path.join(BRIDGE_DIR, "build")
SOURCES = ("CMakeLists.txt", "go1_bridge.cpp", "mini_lcm.hpp", "robot_link.hpp")


def build() -> str:
    """The bridge executable, built when it is missing or older than a
    source."""
    exe = os.path.join(BUILD_DIR, "go1_bridge")
    newest = max(os.path.getmtime(os.path.join(BRIDGE_DIR, f)) for f in SOURCES)
    if os.path.exists(exe) and os.path.getmtime(exe) >= newest:
        return exe
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cmd in (["cmake", ".."], ["make"]):
        res = subprocess.run(cmd, cwd=BUILD_DIR, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the bridge: {' '.join(cmd)} exited "
                               f"{res.returncode}\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return exe


def start(max_ticks: int) -> subprocess.Popen:
    """The bridge as a subprocess on this process's ``LCM_DEFAULT_URL``,
    which stops itself after ``max_ticks`` ticks of 2 ms; the caller waits
    for it or terminates it."""
    return subprocess.Popen([build(), str(int(max_ticks))], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
