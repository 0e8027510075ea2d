"""Demo viewer app — the game-layer port (src/game/game.cppm, main.cpp).

Same control semantics as the reference:
  * ESC closes the window                          (game.cppm:40-50)
  * WASD translates the camera at 6 units/sec in its local frame, x = D-A,
    z = S-W                                        (game.cppm:55-61)
  * left-mouse drag rotates: pitch = -dy*k, yaw = -dx*k with
    k = 0.00390625 rad/px                          (game.cppm:63-78)

Headless runs drive the same handlers through a ScriptedInput fly-through;
``main()`` mirrors the reference's exception-printing entry point
(main.cpp:23-52) including nested-cause unwinding.

The port's counterpart of ``vktf_tpu/game.py``, with the same command
line. It renders on the card; ``start(..., device="cpu")`` and
``main(argv, device="cpu")`` run the kernels' plain versions on the CPU.
Options the port cannot honour raise instead of falling back: ``--backend
tiled|dense`` (the port has the streaming raster alone, which ``auto`` and
``pallas`` name). ``--preview`` is ``--present-format yuv420`` at
``--present-scale`` 2 or more, as in the JAX viewer; ``p`` still saves the
exact full-size frame.

``--mesh GP,SP`` renders through the multi-device frame path
(``parallel/tiles.py``), one process per device under torchrun (one card a
rank under NCCL; gloo on the CPU). Rank 0 owns the window, the input and
``--frame-dir``; the other ranks run headless and follow rank 0's camera,
stills and end of the loop, one small broadcast a frame (``_follow``).
Without the launcher's environment a mesh of more than one rank exits 1,
naming torchrun.

    python -m vktf_tpu_torch.models.export --preset sponza --out assets
    python -m vktf_tpu_torch.game assets/*.gltf --frames 32
    torchrun --standalone --nproc-per-node 4 -m vktf_tpu_torch.game assets/*.gltf --mesh 2,2
"""

from __future__ import annotations

import sys
import traceback
from typing import Optional, Sequence

import numpy as np
import torch

from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.engine import Engine
from vktf_tpu_torch.window import (
    KEY_A,
    KEY_D,
    KEY_ESCAPE,
    KEY_P,
    KEY_S,
    KEY_W,
    MOUSE_BUTTON_LEFT,
    PRESS,
    ScriptedInput,
    Window,
    write_png,
)

TRANSLATE_SPEED = 6.0  # units/sec (game.cppm:56)
DRAG_SPEED = 0.00390625  # rad/px (game.cppm:72)


def create_window(width: int = 1920, height: int = 1080, frame_dir=None,
                  display: Optional[str] = "auto") -> Window:
    window = Window("VkTF-TPU", width, height, frame_dir=frame_dir,
                    display=display)

    def on_key(event):
        if event.key == KEY_ESCAPE and event.action == PRESS:
            window.close()

    window.add_key_event_listener(on_key)
    return window


def handle_key_events(window: Window, camera, delta_time: float) -> None:
    step = TRANSLATE_SPEED * delta_time
    dx = int(window.is_key_pressed(KEY_D)) - int(window.is_key_pressed(KEY_A))
    dz = int(window.is_key_pressed(KEY_S)) - int(window.is_key_pressed(KEY_W))
    if dx or dz:
        camera.translate(np.asarray([step * dx, 0.0, step * dz], np.float32))


class MouseLook:
    """Stateful left-drag rotation (game.cppm:63-78)."""

    def __init__(self) -> None:
        self._prev: Optional[np.ndarray] = None

    def handle(self, window: Window, camera) -> None:
        if not window.is_mouse_button_pressed(MOUSE_BUTTON_LEFT):
            self._prev = None
            return
        position = window.get_cursor_position()
        if self._prev is not None:
            drag = DRAG_SPEED * (position - self._prev)
            camera.rotate(-drag[1], -drag[0])
        self._prev = position


def fly_through_script(num_frames: int = 120) -> ScriptedInput:
    """A bounded WASD+mouse tour standing in for interactive input."""

    def press_w(window):
        window.press_key(KEY_W)

    def start_drag(window):
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(0.0, 0.0)

    def drag(step):
        def action(window):
            window.move_cursor(12.0 * step, 2.0 * step)

        return action

    steps = [press_w] + [None] * (num_frames // 3)
    steps += [start_drag] + [drag(i) for i in range(num_frames // 3)]
    steps += [None] * (num_frames - len(steps)) if num_frames > len(steps) else []
    return ScriptedInput(steps)


def _follow(mesh, camera, running: bool, still: bool) -> tuple[bool, bool]:
    """One frame's control, rank 0's on every rank of the mesh: (running,
    still), and rank 0's camera pose set on the others' cameras."""
    values = mesh.broadcast_host([float(running), float(still), *camera.position,
                                  *camera.orientation])
    if mesh.rank:
        camera.set_pose(values[2:5], values[5:9])
    return bool(values[0]), bool(values[1])


def start(
    asset_paths: Sequence[str],
    width: int = 1920,
    height: int = 1080,
    config: Optional[RenderConfig] = None,
    script: Optional[ScriptedInput] = None,
    frame_dir=None,
    display: Optional[str] = "auto",
    device=None,
    mesh=None,
) -> Window:
    """game::Start port (game.cppm:94-104). ``device``: as Engine's (the
    card by default, "cpu" for the plain versions). ``mesh``: a
    ``parallel.RenderMesh``; ranks other than 0 take neither the window,
    the script nor the frame directory, and follow rank 0 (``_follow``)."""
    leader = mesh is None or mesh.rank == 0
    if not leader:
        script, frame_dir, display = None, None, None
    window = create_window(width, height, frame_dir=frame_dir,
                           display=display)
    if script is not None:
        window.attach_script(script)
    elif leader and not window.has_display:
        # interactive mode with neither a script nor a real display would
        # render forever with no way to press ESC or close the window
        raise RuntimeError(
            "interactive mode needs a reachable display (set $DISPLAY / "
            "--display x11) or an input script"
        )
    engine = Engine(window, config or RenderConfig(width=width, height=height),
                    device=device, mesh=mesh)
    scene = engine.load(asset_paths)
    if scene is None:
        raise RuntimeError("no loadable glTF assets provided")
    mouse_look = MouseLook()

    # 'p' asks for the exact full-resolution still (Scene.render_still),
    # rendered in the frame callback before its input moves the camera
    # (under a mesh every rank renders it)
    still_count = [0]
    still_asked = [False]

    def on_capture(event):
        if event.key == KEY_P and event.action == PRESS:
            still_asked[0] = True

    def save_still():
        from pathlib import Path

        frame = np.moveaxis(scene.render_still(), 0, -1)
        if not leader:
            return
        rgba = np.concatenate([frame, np.full(frame.shape[:2] + (1,), 255, np.uint8)],
                              axis=-1)
        out_dir = Path(frame_dir) if frame_dir else Path.cwd()
        path = write_png(out_dir / f"still_{still_count[0]:05d}.png", rgba)
        still_count[0] += 1
        engine.log.info(f"Saved exact still to {path}")

    window.add_key_event_listener(on_capture)

    def frame(delta_time: float) -> None:
        still, still_asked[0] = still_asked[0], False
        if mesh is not None:
            running, still = _follow(mesh, scene.camera, True, still)
            if not running:
                window.close()
                return
        if still:
            save_still()
        if leader:
            handle_key_events(window, scene.camera, delta_time)
            mouse_look.handle(window, scene.camera)
        engine.render(scene)

    engine.run(frame)
    if mesh is not None and leader:
        _follow(mesh, scene.camera, False, False)
    return window


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """Exception-printing entry point (main.cpp:23-52).

    Unlike the reference (whose asset paths are hard-coded — game.cppm:28
    TODO), the viewer takes paths and render options on the command line.
    ``device`` is passed to ``start`` (callers, such as tests, that render
    on the CPU pass "cpu"); the command line has the JAX viewer's options.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="vktf_tpu_torch.game", description="glTF viewer: scripted fly-through"
    )
    parser.add_argument("assets", nargs="+", help="glTF 2.0 files (.gltf/.glb)")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--msaa", type=int, default=4)
    parser.add_argument("--frames", type=int, default=120,
                        help="fly-through length in frames")
    parser.add_argument("--frame-dir", default=None,
                        help="dump presented frames as PNGs into this directory")
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "pallas", "tiled", "dense"],
                        help="raster backend: auto and pallas are the streaming "
                             "raster; tiled and dense are not ported")
    parser.add_argument("--display", default="auto",
                        choices=["auto", "x11", "off"],
                        help="present sink: auto attaches an X11 window when "
                             "$DISPLAY is reachable (the reference's GLFW "
                             "window, window.cppm:28-214), off stays headless")
    parser.add_argument("--interactive", action="store_true",
                        help="skip the scripted fly-through; WASD/mouse/ESC "
                             "drive the camera until the window closes")
    parser.add_argument("--anisotropy", type=float, default=16.0,
                        help="max sampler anisotropy (1 = off; the reference "
                             "enables device-max anisotropy when available, "
                             "model.cppm:261-275)")
    parser.add_argument("--present-format", default="rgb",
                        choices=("rgb", "yuv420"),
                        help="device-side present encoding: rgb = exact "
                             "planar frame; yuv420 = BT.601 4:2:0 (half the "
                             "device->host present bytes — for remote/"
                             "link-bound viewing, ops/present.py)")
    parser.add_argument("--aniso-taps", type=int, default=1,
                        choices=[1, 2, 4, 8],
                        help="true multi-tap anisotropic filtering (1 = "
                             "single-tap LOD sharpening; N taps cost ~N x "
                             "the texture-gather time)")
    parser.add_argument("--present-scale", type=int, default=1,
                        choices=[1, 2, 4],
                        help="preview present stream: device-side box "
                             "downsample of the presented frame (4x/16x "
                             "fewer present bytes; render stays full-res, "
                             "'p' saves an exact full-res still)")
    parser.add_argument("--preview", action="store_true",
                        help="shorthand for --present-scale 2 "
                             "--present-format yuv420 (8x fewer present "
                             "bytes for link-bound interactive viewing)")
    parser.add_argument("--peel-layers", type=int, default=None,
                        choices=range(1, 9), metavar="K",
                        help="depth-peel layer override (default: scene-"
                             "derived, 1 + translucent instances, up to 8; "
                             "all-opaque scenes use 1)")
    parser.add_argument("--mesh", default=None, metavar="GP,SP",
                        help="render through the multi-device frame path over a "
                             "(gp, sp) mesh of processes (vktf_tpu_torch.parallel; "
                             "under torchrun --nproc-per-node GP*SP)")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    try:
        _refuse_unported(args)
        present_format, present_scale = args.present_format, args.present_scale
        if args.preview:
            present_format, present_scale = "yuv420", max(2, present_scale)
        config = RenderConfig(
            width=args.width, height=args.height, msaa_samples=args.msaa,
            max_anisotropy=args.anisotropy, aniso_taps=args.aniso_taps,
            peel_layers=args.peel_layers,
            present_format=present_format, present_scale=present_scale,
        )
        run = dict(
            width=args.width,
            height=args.height,
            config=config,
            script=None if args.interactive
            else fly_through_script(args.frames),
            frame_dir=args.frame_dir,
            display=None if args.display == "off" else args.display,
        )
        if args.mesh:
            from vktf_tpu_torch.parallel.launch import launcher_mesh

            gp, sp = (int(x) for x in args.mesh.split(","))
            kind = "cuda" if device is None else torch.device(device).type
            with launcher_mesh(gp, sp, kind) as (mesh, rank_device):
                start(args.assets, **run, device=rank_device, mesh=mesh)
        else:
            start(args.assets, **run, device=device)
        return 0
    except Exception as error:  # nested-exception unwinding analogue
        cause: BaseException | None = error
        while cause is not None:
            print(f"Error: {cause}", file=sys.stderr)
            cause = cause.__cause__
        traceback.print_exc()
        return 1


def _refuse_unported(args) -> None:
    """Raise on a viewer option whose path the port does not have."""
    if args.backend in ("tiled", "dense"):
        raise ValueError(f"--backend {args.backend} is not ported: the port has the "
                         "streaming raster alone (--backend auto or pallas)")


if __name__ == "__main__":
    sys.exit(main())
