"""Random draws at fixed positions: the port's counterpart of
`jax.random.fold_in`, for dropout (alphafold2_tpu/training/harness.py:171,
the microbatch index folded into the step's key) and for the serving
engine's random MDS init (alphafold2_tpu/serving/engine.py:1304, the
dispatch index folded into the seed's key).

A `Streams` owns torch generators on one device, each at a position: a
path of ints and strings such as (microbatch, "trunk", layer) or
(microbatch, "trunk", layer, block). A `Key` is a position (`fold_in`
extends its path) and `Key.generator()` gives the generator its ops draw
their masks from in turn. Every generator is seeded by the streams' seed
folded with its path (`path_seed`), so what a position draws depends on
the seed and the path only, never on which position drew first.

A position's ops can run more than once in a step: `torch.utils.checkpoint`
recomputes a layer in the backward pass (its `preserve_rng_state` saves
and restores the default generator only), and the reversible trunk's
backward recomputes each block. Each run of a position is a pass, and each
pass has its own generator, seeded alike, so a recompute draws the
forward's masks. The passes are counted from the last `set_seed`. A
generator shared by the passes cannot be rewound inside a CUDA graph: a
capture moves its position only forward, and a clone of its state is a
generator the graph does not know.

On the card a graph that draws is captured under `Streams.capturing`:
every generator of the streams is registered with the graph
(`torch.cuda.CUDAGraph.register_generator_state`), the passes start again
from 0 and no generator may be made (a position the warm-up did not draw
raises). A replay then draws from each generator's seed and offset at the
replay, so `set_seed` before `replay()` gives the step's masks, the same
bits the eager run draws from the same seed. On the CPU the same streams
hold CPU generators.

A data-parallel shard (parallel/train.py) holds some rows of the global
batch, and its draws over the batch must be its rows of the draw the whole
batch would make. Its streams carry those rows (`Streams(rows=)`), and
every generator they make is tagged with them (read by `rows_of` in
ops/core.py `rand_rows`; `tagged_rows` tags a generator for a block). The rows go wherever the generator
goes: into a recompute on autograd's threads, and nowhere else. A draw
from an untagged generator, on any thread, is the plain draw.
"""

from __future__ import annotations

import contextlib
import weakref
import zlib
from typing import Optional

import torch

_MASK64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data) -> int:
    """A new seed in [0, 2^63) from `seed` and `data` (an int, or a str
    taken by its crc32)."""
    if isinstance(data, str):
        data = zlib.crc32(data.encode()) | (1 << 32)  # apart from the ints 0 .. 2^32
    return _mix(_mix(seed & _MASK64) ^ (data & _MASK64)) >> 1


def path_seed(seed: int, path) -> int:
    """`seed` folded with each element of `path` in turn."""
    for data in path:
        seed = fold_in(seed, data)
    return seed


def seed_from(rng: torch.Generator) -> int:
    """One draw from a CPU generator (a step's rng): the seed it hands a
    `Streams`."""
    return int(torch.randint(2 ** 62, (), generator=rng))


# id(generator) -> (generator, (start, count, total)): the rows of a
# `total`-row batch that the generator's draws over the batch stand for.
# Keyed by id with the generator held, since a torch generator takes no
# weak reference in every release; an entry goes with its Streams
# (`weakref.finalize`) or at the end of its `tagged_rows` block.
_ROWS = {}


def checked_rows(rows) -> tuple:
    """`rows` = (start, count, total) as ints, refused where the rows lie
    outside the batch."""
    start, count, total = (int(r) for r in rows)
    if not (0 <= start and count > 0 and start + count <= total):
        raise ValueError(f"batch rows {start} .. {start + count} outside a batch of {total}")
    return start, count, total


def rows_of(generator: Optional[torch.Generator]):
    """The (start, count, total) batch rows `generator` carries, or None."""
    entry = None if generator is None else _ROWS.get(id(generator))
    return entry[1] if entry is not None and entry[0] is generator else None


def _untag(ids) -> None:
    for i in ids:
        _ROWS.pop(i, None)


@contextlib.contextmanager
def tagged_rows(generator: torch.Generator, rows):
    """Within the block, `generator`'s draws over the batch take rows
    start .. start + count of a `total`-row batch's draw (`rows` =
    (start, count, total); None: the whole batch, nothing tagged)."""
    if rows is None:
        yield generator
        return
    _ROWS[id(generator)] = (generator, checked_rows(rows))
    try:
        yield generator
    finally:
        _untag([id(generator)])


class Streams:
    """The generators of one step or one engine on `device`, at fixed
    positions (see the module docstring). `key()` is the root position.
    `rows`: a data-parallel shard's (start, count, total) batch rows, with
    which every generator is tagged while the streams live (`rows_of`;
    None: the whole batch)."""

    def __init__(self, device, seed: int = 0, rows=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.seed = int(seed)
        self.rows = None if rows is None else checked_rows(rows)
        self._tagged = []  # ids of the generators tagged with self.rows
        if self.rows is not None:
            weakref.finalize(self, _untag, self._tagged)
        self._generators = {}  # path -> [one generator a pass]
        self._passes = {}      # path -> passes drawn since the last set_seed
        self._sealed = False

    def key(self) -> "Key":
        return Key(self, ())

    def set_seed(self, seed: int) -> None:
        """Seed every generator by `seed` folded with its path, each at its
        start, and count the passes from 0 again."""
        self.seed = int(seed)
        self._passes.clear()
        for path, gens in self._generators.items():
            s = path_seed(self.seed, path)
            for g in gens:
                g.manual_seed(s)

    def generator(self, path) -> torch.Generator:
        """The generator of `path`'s next pass, made at its first use."""
        n = self._passes.get(path, 0)
        self._passes[path] = n + 1
        gens = self._generators.setdefault(path, [])
        if n == len(gens):
            if self._sealed:
                raise RuntimeError(
                    f"random position {path} (pass {n}) was not drawn before the capture: a "
                    f"generator made now would not be registered with the graph, which would "
                    f"freeze its draws")
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"random position {path}: a CUDA graph is being captured outside "
                    f"Streams.capturing, so the graph cannot replay this generator's draws")
            gen = torch.Generator(self.device).manual_seed(path_seed(self.seed, path))
            if self.rows is not None:
                _ROWS[id(gen)] = (gen, self.rows)
                self._tagged.append(id(gen))
            gens.append(gen)
        return gens[n]

    def generators(self) -> list:
        return [g for gens in self._generators.values() for g in gens]

    @contextlib.contextmanager
    def capturing(self, graph):
        """Around `torch.cuda.graph(graph, ...)`: register every generator
        with `graph` (before its capture begins), count the passes from 0
        and refuse new positions until the capture ends."""
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                "torch.cuda.CUDAGraph has no register_generator_state in this PyTorch "
                f"({torch.__version__}): a capture would freeze the random draws")
        for g in self.generators():
            register(g)
        self._passes.clear()
        self._sealed = True
        try:
            yield self
        finally:
            self._sealed = False


class Key:
    """A position of a `Streams` (JAX's PRNG key after its `fold_in`s)."""

    __slots__ = ("streams", "path")

    def __init__(self, streams: Streams, path: tuple):
        self.streams, self.path = streams, path

    def fold_in(self, *data) -> "Key":
        return Key(self.streams, self.path + data)

    @property
    def seed(self) -> int:
        """The seed of this position's generators (for a host draw)."""
        return path_seed(self.streams.seed, self.path)

    def generator(self) -> torch.Generator:
        """The generator of this position's next pass."""
        return self.streams.generator(self.path)


def as_key(rng, device) -> Optional[Key]:
    """A forward's rng as a Key on `device`: None stays None (eval mode), a
    Key is taken as it is (its streams must lie on the device's type), and
    a CPU generator gives new streams seeded by one draw from it
    (`seed_from`)."""
    if rng is None:
        return None
    if isinstance(rng, Key):
        if rng.streams.device.type != torch.device(device).type:
            raise ValueError(f"the rng's streams lie on {rng.streams.device}, the forward "
                             f"runs on {device}")
        return rng
    return Streams(device, seed_from(rng)).key()
