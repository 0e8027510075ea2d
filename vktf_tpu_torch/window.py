"""Window / input shim.

The reference wraps GLFW: a fullscreen window with key/mouse polling, key
-event listeners, and surface creation (src/engine/window.cppm:28-214). This
environment is headless, so the TPU build provides a display-agnostic
``Window`` with the same input surface — key/cursor state polling, key-event
listeners, close handling — plus pluggable "present" sinks (in-memory frame
grab, PNG dump directory) and a ``ScriptedInput`` replay used by the demo
fly-through and benchmarks to stand in for a human at the keyboard
(src/game/game.cppm:55-78 control semantics).

The port's counterpart of ``vktf_tpu/window.py``. The PNG dump of
``frame_dir`` is written by ``write_png`` with the standard library's zlib,
so it needs no PIL.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np

# Key identifiers mirror GLFW names used by the game app (game.cppm:40-61).
KEY_ESCAPE = "escape"
KEY_W, KEY_A, KEY_S, KEY_D = "w", "a", "s", "d"
KEY_P = "p"  # exact-still capture in the viewer (game.py)
MOUSE_BUTTON_LEFT = "mouse_left"

PRESS, RELEASE = "press", "release"


@dataclasses.dataclass
class KeyEvent:
    key: str
    action: str  # PRESS or RELEASE


class Window:
    """Headless window: input state + frame sink.

    API parity with the reference Window (window.cppm:28-109): size queries,
    close flag, key/mouse polling, key-event listeners. ``update()`` is the
    glfwPollEvents analogue — it advances the attached input script (if any)
    and dispatches key events to listeners.
    """

    def __init__(
        self,
        title: str = "VkTF-TPU",
        width: int = 1920,
        height: int = 1080,
        frame_dir: Optional[str | Path] = None,
        display: Optional[str] = None,
    ):
        self.title = title
        self._width = width
        self._height = height
        self._closed = False
        self._keys_down: set[str] = set()
        self._mouse_down: set[str] = set()
        self._cursor = np.zeros(2, np.float64)
        self._listeners: list[Callable[[KeyEvent], None]] = []
        self._script: Optional["ScriptedInput"] = None
        self._frame_dir = Path(frame_dir) if frame_dir else None
        if self._frame_dir:
            self._frame_dir.mkdir(parents=True, exist_ok=True)
        self._frame_count = 0
        self.last_frame: Optional[np.ndarray] = None
        # optional real display (the reference's GLFW window,
        # window.cppm:28-214): "auto" attaches an X11 window when $DISPLAY
        # is reachable, "x11" requires one, None (the library default —
        # embedders and tests must not acquire X side effects implicitly;
        # the viewer CLI passes "auto") stays headless.
        self._display = None
        if display == "auto" or display == "x11":
            from vktf_tpu_torch.x11 import X11Display

            if X11Display.available():
                self._display = X11Display(title, width, height)
            elif display == "x11":
                raise RuntimeError(
                    "display='x11' requested but no X display is reachable"
                )

    # -- geometry ------------------------------------------------------------
    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    @property
    def aspect_ratio(self) -> float:
        return self._width / self._height

    # -- lifecycle -----------------------------------------------------------
    def is_closed(self) -> bool:
        return self._closed

    @property
    def has_display(self) -> bool:
        """True when a real on-screen present sink is attached."""
        return self._display is not None

    def close(self) -> None:
        self._closed = True
        if self._display is not None:
            self._display.close()
            self._display = None

    # -- input polling (window.cppm:60-96) ------------------------------------
    def is_key_pressed(self, key: str) -> bool:
        return key in self._keys_down

    def is_mouse_button_pressed(self, button: str) -> bool:
        return button in self._mouse_down

    def get_cursor_position(self) -> np.ndarray:
        return self._cursor.copy()

    def add_key_event_listener(self, listener: Callable[[KeyEvent], None]) -> None:
        self._listeners.append(listener)

    # -- programmatic input (tests/scripts) -----------------------------------
    def press_key(self, key: str) -> None:
        self._keys_down.add(key)
        self._dispatch(KeyEvent(key, PRESS))

    def release_key(self, key: str) -> None:
        self._keys_down.discard(key)
        self._dispatch(KeyEvent(key, RELEASE))

    def press_mouse(self, button: str) -> None:
        self._mouse_down.add(button)

    def release_mouse(self, button: str) -> None:
        self._mouse_down.discard(button)

    def move_cursor(self, x: float, y: float) -> None:
        self._cursor[:] = (x, y)

    def _dispatch(self, event: KeyEvent) -> None:
        for listener in self._listeners:
            listener(event)

    def attach_script(self, script: "ScriptedInput") -> None:
        self._script = script

    def update(self) -> None:
        """Poll events (glfwPollEvents analogue)."""
        if self._script is not None:
            self._script.step(self)
        if self._display is not None:
            for ev in self._display.poll():
                if ev[0] == "key":
                    _, key, pressed = ev
                    (self.press_key if pressed else self.release_key)(key)
                elif ev[0] == "mouse":
                    _, button, pressed = ev
                    (self.press_mouse if pressed
                     else self.release_mouse)(button)
                elif ev[0] == "motion":
                    self.move_cursor(ev[1], ev[2])
                elif ev[0] == "close":
                    self.close()

    # -- presentation ----------------------------------------------------------
    def present(self, frame: np.ndarray) -> None:
        """Consume a rendered uint8 frame (the swapchain present).

        Accepts planar (3, H, W) RGB or (4, H, W) RGBA — the frame program's
        output layout; the constant alpha=255 is synthesized here — or
        interleaved (H, W, C); stores/saves interleaved RGBA. The window
        keeps its own copy, so the caller may reuse its buffer at once.
        """
        if frame.ndim == 3 and frame.shape[0] in (3, 4) and frame.shape[-1] not in (3, 4):
            channels, height, width = frame.shape
            rgba = np.empty((height, width, 4), np.uint8)
            rgba[..., :channels] = np.moveaxis(frame, 0, -1)
        else:
            height, width, channels = frame.shape
            rgba = np.empty((height, width, 4), np.uint8)
            rgba[..., :channels] = frame
        if channels == 3:
            rgba[..., 3] = 255
        frame = rgba
        self.last_frame = frame
        if self._display is not None:
            self._display.present(frame)
        if self._frame_dir is not None:
            write_png(self._frame_dir / f"frame_{self._frame_count:05d}.png", frame)
        self._frame_count += 1


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> Path:
    """Write an (H, W, 3) or (H, W, 4) uint8 image as an 8-bit RGB (colour
    type 2) or RGBA (colour type 6) PNG (no filtering, one zlib stream)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes an (H, W, 3|4) uint8 image, got {image.shape}")
    height, width, channels = image.shape
    rows = np.zeros((height, 1 + channels * width), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = image.reshape(height, channels * width)
    colour_type = 2 if channels == 3 else 6
    header = struct.pack(">IIBBBBB", width, height, 8, colour_type, 0, 0, 0)
    path = Path(path)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                     + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + _png_chunk(b"IEND", b""))
    return path


class ScriptedInput:
    """Replays a sequence of per-frame input actions against a Window.

    Each entry is a callable(window) invoked once per update; when the script
    is exhausted the window is closed (bounded demo runs).
    """

    def __init__(self, steps: Iterable[Callable[[Window], None]], close_at_end: bool = True):
        self._steps = list(steps)
        self._index = 0
        self._close_at_end = close_at_end

    def step(self, window: Window) -> None:
        if self._index < len(self._steps):
            action = self._steps[self._index]
            if action is not None:
                action(window)
            self._index += 1
        elif self._close_at_end:
            window.close()
