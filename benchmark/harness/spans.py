"""Named spans around the program's calls, set from outside the program.

`Spans.wrap(obj, attribute, name)` replaces `obj.attribute` (a method or a
callable attribute) on the instance by a wrapper that opens a
`record_function(name)` span while `on` (the traced stretch only) and, for
a call whose `record` hook is set, hands the hook the call's arguments and
result. Off and unhooked, a wrapped call costs one Python call.
"""

from __future__ import annotations

from typing import Callable, Optional


class Spans:
    def __init__(self):
        self.on = False
        self.names = set()
        self.hooks = {}

    def wrap(self, obj, attribute: str, name: str) -> None:
        from torch.profiler import record_function

        fn = getattr(obj, attribute)
        self.names.add(name)

        def spanned(*args, **kwargs):
            hook: Optional[Callable] = self.hooks.get(name)
            if self.on:
                with record_function(name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if hook is not None:
                hook(args, kwargs, out)
            return out

        setattr(obj, attribute, spanned)
