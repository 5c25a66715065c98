"""Free-list allocator over the shared paged KV-cache pool: a copy of
``repro.serve.page_pool``.

Host-side bookkeeping only — the pages themselves are the leading dim of
the device pools built by ``transformer.init_paged_pools``, read in place
by the paged decode kernel (K12) through per-request page tables.
Allocation order is deterministic (LIFO free list) so a serving run is a
pure function of its request stream; ownership is tracked per page so
tests can prove no leak and no double-free across request lifetimes.
"""

from __future__ import annotations


class OutOfPages(RuntimeError):
    """Admission asked for more pages than the pool has free."""


class PagePool:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO stack, seeded so the first allocations are 0, 1, 2, ...
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._owner: dict[int, int] = {}  # page -> rid

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_tokens(self) -> int:
        return self.num_free * self.page_size

    def pages_for(self, tokens: int) -> int:
        """Pages covering ``tokens`` cache slots (0 tokens -> 0 pages)."""
        return -(-int(tokens) // self.page_size)

    def alloc(self, n: int, owner: int) -> list[int]:
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPages(
                f"request {owner} needs {n} pages, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: list[int], owner: int) -> None:
        for p in pages:
            if self._owner.get(p) != owner:
                raise ValueError(
                    f"page {p} not owned by request {owner} "
                    f"(owner: {self._owner.get(p)})"
                )
            del self._owner[p]
        # return in reverse so a re-allocation of the same count gets the
        # same pages back in the same order (deterministic replay)
        self._free.extend(reversed(pages))

    def assert_empty(self) -> None:
        """Leak check: every page returned, free list intact."""
        if self._owner:
            raise AssertionError(f"leaked pages: {sorted(self._owner)}")
        if len(self._free) != self.num_pages:
            raise AssertionError(
                f"free list holds {len(self._free)}/{self.num_pages} pages"
            )
