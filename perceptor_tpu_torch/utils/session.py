"""Session checkpoint and resume: drawer parameters, optimizer state,
generator state and step (counterpart of perceptor_tpu/utils/session.py).

A session is a dict such as::

    {"params": drawer.state_dict(),
     "opt_state": optimizer.state_dict(),
     "generator": generator,
     "step": 3}

written with `torch.save` and read back with `torch.load(weights_only=True)`
(no code runs on load). `torch.Generator`s stand where the JAX package has
PRNG keys: a generator in the state is stored as its state tensor and, on
load, restored into the generator that `like` holds at the same place, so
the resumed run draws exactly the numbers the uninterrupted one would have.
`like` gives the structure to restore into, as in JAX; its tensors are not
overwritten (the loaded ones are returned), except the generators'.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Optional

import torch

_GENERATOR_TAG = "__torch_generator_state__"
_SUFFIX = ".pt"


def _to_storable(state: Any, copy: bool = False) -> Any:
    """The state with each generator replaced by its tagged state tensor and,
    with `copy`, every tensor copied to host memory (for a background
    write that must not see later in-place updates)."""
    if isinstance(state, torch.Generator):
        return {_GENERATOR_TAG: state.get_state()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True) if copy else state.detach()
    if isinstance(state, dict):
        return {key: _to_storable(value, copy) for key, value in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_storable(value, copy) for value in state)
    return state


def _restore(stored: Any, like: Any) -> Any:
    """`stored` with each tagged generator state set into the generator at
    the same place in `like` (which is returned in its place)."""
    if isinstance(like, torch.Generator):
        if not (isinstance(stored, dict) and _GENERATOR_TAG in stored):
            raise ValueError("the session holds no generator state where `like` has one")
        like.set_state(stored[_GENERATOR_TAG])
        return like
    if isinstance(like, dict) and isinstance(stored, dict):
        return {key: _restore(value, like.get(key)) for key, value in stored.items()}
    if isinstance(like, (list, tuple)) and isinstance(stored, (list, tuple)):
        return type(stored)(_restore(s, l) for s, l in zip(stored, like))
    return stored


def _write(path: str, storable: Any) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(storable, tmp)
    os.replace(tmp, path)


def save_session(path: str, state: Any) -> str:
    """Write a session dict to `path` (atomically: a partial file never
    replaces a complete one) and return the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write(path, _to_storable(state))
    return path


def load_session(path: str, like: Any) -> Any:
    """A session saved by `save_session`. Generators in `like` get their
    stored state; the rest is returned as loaded (tensors on the devices
    they were saved from)."""
    stored = torch.load(os.path.abspath(path), weights_only=True)
    return _restore(stored, like)


# SIGTERM is what a preempted VM or a batch scheduler sends before it stops
# a process; the handler below records it for `reached_preemption`.
_PREEMPTED = threading.Event()
_handler_lock = threading.Lock()
_handler_installed = False


def _install_sigterm_handler() -> None:
    """Record SIGTERM (chaining to any earlier handler) once per process;
    only the main thread may install signal handlers."""
    global _handler_installed
    with _handler_lock:
        if _handler_installed or threading.current_thread() is not threading.main_thread():
            return
        previous = signal.getsignal(signal.SIGTERM)

        def on_sigterm(signum, frame):
            _PREEMPTED.set()
            if callable(previous):
                previous(signum, frame)

        signal.signal(signal.SIGTERM, on_sigterm)
        _handler_installed = True


class SessionManager:
    """Periodic, optionally asynchronous, preemption-aware session
    checkpoints in `directory`, one file per step (`step_<n>.pt`).

    - **interval**: `save(step, state)` writes only when `should_save(step)`
      (the first step, then every `save_interval_steps` after the newest
      checkpoint) or with `force=True`, so it can sit in the loop;
    - **idempotent**: saving a step that is already on disk does nothing;
    - **preemption**: once the process has received SIGTERM, the signal a
      preempted VM or a batch scheduler sends (and what orbax's preemption
      sync reports on a TPU slice), `reached_preemption` is True and `save`
      writes at once, whatever the interval, and waits for the write;
    - **async**: with `async_save`, `save` copies the state to host memory
      on the caller's thread and writes it on a background thread; `wait()`
      or `close()` joins the writes;
    - **retention**: the newest `max_to_keep` steps are kept.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self._interval = max(1, int(save_interval_steps))
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        self._threads: list = []
        self._lock = threading.Lock()
        self._pending: set = set()
        os.makedirs(self.directory, exist_ok=True)
        _install_sigterm_handler()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}{_SUFFIX}")

    def all_steps(self):
        """The steps on disk and those being written, ascending."""
        steps = set(self._pending)
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(_SUFFIX):
                try:
                    steps.add(int(name[5:-len(_SUFFIX)]))
                except ValueError:
                    pass
        return sorted(steps)

    def reached_preemption(self, step: int) -> bool:
        """True once the process has received SIGTERM."""
        return _PREEMPTED.is_set()

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        return not steps or int(step) >= steps[-1] + self._interval

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Checkpoint `state` at `step` if the policy says so; returns
        whether a save was issued."""
        step = int(step)
        if step in self.all_steps():
            return False
        preempted = self.reached_preemption(step)
        if not (force or preempted or self.should_save(step)):
            return False
        if self._async and not preempted:
            storable = _to_storable(state, copy=True)
            with self._lock:
                self._pending.add(step)
            thread = threading.Thread(target=self._write_and_prune, args=(step, storable),
                                      daemon=True)
            thread.start()
            self._threads.append(thread)
        else:
            self._write_and_prune(step, _to_storable(state))
            if preempted:
                self.wait()
        return True

    def _write_and_prune(self, step: int, storable: Any) -> None:
        with self._lock:
            self._pending.add(step)
            try:
                _write(self._path(step), storable)
            finally:
                self._pending.discard(step)
            if self._max_to_keep is not None:
                for old in self.all_steps()[: -self._max_to_keep]:
                    if old not in self._pending and os.path.exists(self._path(old)):
                        os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        self.wait()
        return load_session(self._path(step), like)

    def restore_latest(self, like: Any):
        """(step, state) for the newest checkpoint, or None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like)

    def wait(self) -> None:
        """Join every outstanding background write."""
        while self._threads:
            self._threads.pop().join()

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "SessionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
