"""Mutable link primitives: gate expressions and attribute aliasing.

The port's own copy of :mod:`veles_tpu.mutable`:

* ``Bool``: a mutable boolean cell with lazy boolean *expressions*
  (``&``, ``|``, ``^``, ``~``) recomputed from their operands at read
  time, and in-place rebinding with ``<<=``.  Units gate on these
  (``gate_block`` / ``gate_skip``), so flipping one Decision flag
  re-gates the whole graph without re-linking.  A ``Bool`` pickles its
  value and its expression, whose operator is a module-level function,
  so a snapshot keeps its gates live.
* ``LinkableAttribute``: aliases an attribute of one object to an
  attribute of another (optionally two-way); ``Unit.link_attrs`` builds
  the dataflow edges with it.  The forwarding descriptors live on the
  class, so an object unpickled in a fresh process installs them again
  (``reinstall``, which ``Unit.init_unpickled`` calls).
"""


def _op_and(a, b):
    return a and b


def _op_or(a, b):
    return a or b


def _op_xor(a, b):
    return a != b


def _op_not(a):
    return not a


def _op_truth(a):
    return a


class Bool(object):
    """Mutable, composable boolean cell.

    Expressions are built from module-level operator functions (not
    lambdas) so they pickle: a snapshotted workflow keeps its gate
    expressions live, and the pickle memo keeps the operands' identity
    (two gates sharing one Decision flag still share it when loaded)."""

    __slots__ = ("_value", "_expr")

    def __init__(self, value=False):
        if isinstance(value, Bool):
            self._value = None
            self._expr = (_op_truth, (value,))
        else:
            self._value = bool(value)
            self._expr = None

    def __bool__(self):
        if self._expr is not None:
            fn, operands = self._expr
            return bool(fn(*[bool(op) for op in operands]))
        return self._value

    def __ilshift__(self, value):
        """``b <<= x``: rebind, keeping the object's identity so every
        gate holding this cell sees the new value."""
        if isinstance(value, Bool):
            if value._expr is not None:
                self._expr = value._expr
                self._value = None
            else:
                self._expr = None
                self._value = value._value
        else:
            self._expr = None
            self._value = bool(value)
        return self

    def _compose(self, fn, other):
        result = Bool()
        result._expr = (fn, (self, other))
        result._value = None
        return result

    def __and__(self, other):
        return self._compose(_op_and, _coerce(other))

    def __or__(self, other):
        return self._compose(_op_or, _coerce(other))

    def __xor__(self, other):
        return self._compose(_op_xor, _coerce(other))

    def __invert__(self):
        result = Bool()
        result._expr = (_op_not, (self,))
        return result

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __repr__(self):
        kind = "expr" if self._expr is not None else "value"
        return "<Bool %s=%s at 0x%x>" % (kind, bool(self), id(self))

    def __getstate__(self):
        return (self._value, self._expr)

    def __setstate__(self, state):
        self._value, self._expr = state


def _coerce(value):
    return value if isinstance(value, Bool) else Bool(value)


class LinkableAttribute(object):
    """Alias ``obj.name`` to ``src.src_name``, per instance: the links
    live in the target's ``_linked_attrs`` dict and a forwarding
    descriptor on its class reads them."""

    @staticmethod
    def link(dst, dst_name, src, src_name, two_way=False):
        links = dst.__dict__.setdefault("_linked_attrs", {})
        links[dst_name] = (src, src_name, two_way)
        _install_forwarding(type(dst), dst_name)

    @staticmethod
    def reinstall(obj):
        """Install the forwarding descriptors of ``obj``'s links again:
        ``link()`` changes the class, which is local to the process,
        while ``_linked_attrs`` pickles with the instance."""
        for name in obj.__dict__.get("_linked_attrs", {}):
            _install_forwarding(type(obj), name)


class _Forward(object):
    """Data descriptor forwarding instance attribute access through
    ``_linked_attrs`` when a link exists, else the instance dict."""

    __slots__ = ("name", "default", "has_default")

    def __init__(self, name, default=None, has_default=False):
        self.name = name
        self.default = default
        self.has_default = has_default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        link = obj.__dict__.get("_linked_attrs", {}).get(self.name)
        if link is not None:
            src, src_name, _ = link
            return getattr(src, src_name)
        try:
            return obj.__dict__[self.name]
        except KeyError:
            if self.has_default:
                return self.default
            raise AttributeError(
                "%r has no attribute %r" % (obj, self.name)) from None

    def __set__(self, obj, value):
        link = obj.__dict__.get("_linked_attrs", {}).get(self.name)
        if link is not None:
            src, src_name, two_way = link
            if two_way:
                setattr(src, src_name, value)
                return
            raise RuntimeError(
                "attribute %r of %r is one-way linked from %r.%s; assigning "
                "it would silently detach the dataflow edge — link with "
                "two_way=True" % (self.name, obj, src, src_name))
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        obj.__dict__.get("_linked_attrs", {}).pop(self.name, None)
        obj.__dict__.pop(self.name, None)


def _install_forwarding(cls, name):
    sentinel = object()
    current = getattr(cls, name, sentinel)
    if isinstance(current, _Forward):
        return
    if isinstance(current, property) or callable(current):
        raise ValueError(
            "cannot link over existing class attribute %s.%s (%r) — pick a "
            "different destination name" % (cls.__name__, name, current))
    if current is not sentinel:
        setattr(cls, name, _Forward(name, default=current, has_default=True))
    else:
        setattr(cls, name, _Forward(name))
