"""Functions of the engine replaced from outside, and put back.

``Patches.patch(owner, attr, around)`` replaces ``owner.attr`` by a function
that hands ``around`` the original and the call's arguments; ``restore()``
puts every original back. ``Spans.wrap(owner, attr, name)`` is such a patch
that runs the call inside a ``torch.profiler.record_function(name)`` range,
with no synchronisation, while ``active``; a hook may also keep the call's
arguments for the counters.
"""

import torch


class Patches:
    def __init__(self):
        self._undo = []

    def patch(self, owner, attr, around):
        fn = getattr(owner, attr)
        own = attr in vars(owner)

        def patched(*args, **kwargs):
            return around(fn, *args, **kwargs)

        setattr(owner, attr, patched)
        self._undo.append(lambda: setattr(owner, attr, fn) if own else delattr(owner, attr))

    def restore(self):
        while self._undo:
            self._undo.pop()()


class Spans(Patches):
    def __init__(self):
        super().__init__()
        self.active = False
        self.calls = {}     # name -> list of whatever the hooks kept

    def wrap(self, owner, attr, name, keep=None):
        kept = self.calls.setdefault(name, [])

        def spanned(fn, *args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            if keep is not None:
                kept.append(keep(*args, **kwargs))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        self.patch(owner, attr, spanned)
