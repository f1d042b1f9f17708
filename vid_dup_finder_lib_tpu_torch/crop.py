"""Edge-offset crop rectangles.

Behavioral port of the reference's ``Crop``
(``vid_dup_finder_common/src/crop.rs:4-196``): a crop is stored as the pixel
counts shaved off each edge of an ``orig_res`` (width, height) frame.  The
``union`` of two crops takes the *minimum* of each edge offset (the loosest
crop covering both).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Crop:
    orig_res: tuple[int, int]  # (width, height)
    left: int = 0
    right: int = 0
    top: int = 0
    bottom: int = 0

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_edge_offsets(
        orig_res: tuple[int, int], left: int, right: int, top: int, bottom: int
    ) -> "Crop":
        # Same non-degeneracy asserts as crop.rs:14-30.
        assert left + right < orig_res[0], "crop wider than frame"
        assert top + bottom < orig_res[1], "crop taller than frame"
        return Crop(orig_res, left, right, top, bottom)

    @staticmethod
    def from_topleft_and_dims(
        orig_res: tuple[int, int], x: int, y: int, width: int, height: int
    ) -> "Crop":
        orig_width, orig_height = orig_res
        return Crop(
            orig_res,
            left=x,
            right=orig_width - width - x,
            top=y,
            bottom=orig_height - height - y,
        )

    # -- combination -------------------------------------------------------

    def union(self, other: "Crop") -> "Crop":
        """Loosest crop covering both (min of each edge). crop.rs:53-68."""
        return Crop.from_edge_offsets(
            self.orig_res,
            min(self.left, other.left),
            min(self.right, other.right),
            min(self.top, other.top),
            min(self.bottom, other.bottom),
        )

    def biggest_crop(self, other: "Crop") -> "Crop":
        """The crop with the larger |right-left| x |bottom-top| (crop.rs:71-92).

        Note: reproduces the reference's quirky area metric verbatim.
        """
        assert self.orig_res == other.orig_res
        t_dim = abs(self.right - self.left) * abs(self.bottom - self.top)
        o_dim = abs(other.right - other.left) * abs(other.bottom - other.top)
        return self if t_dim < o_dim else other

    # -- geometry ----------------------------------------------------------

    def as_view_args(self) -> tuple[int, int, int, int]:
        """(x, y, width, height) of the retained region. crop.rs:95-108."""
        orig_width, orig_height = self.orig_res
        width = orig_width - (self.left + self.right)
        height = orig_height - (self.top + self.bottom)
        assert width >= 0 and height >= 0
        return (self.left, self.top, width, height)

    @property
    def width(self) -> int:
        return self.orig_res[0] - (self.left + self.right)

    @property
    def height(self) -> int:
        return self.orig_res[1] - (self.top + self.bottom)

    @property
    def area(self) -> int:
        return self.width * self.height

    @property
    def aspect_ratio(self) -> float:
        return float(self.width) / float(self.height)

    def enumerate_coords(self):
        """(x, y) pairs inside the retained region, x-major. crop.rs:121-135."""
        orig_x, orig_y = self.orig_res
        for x in range(self.left, orig_x - self.right):
            for y in range(self.top, orig_y - self.bottom):
                yield (x, y)

    def enumerate_coords_excluded(self):
        """(x, y) pairs in the excluded border ring. crop.rs:137-159."""
        orig_x, orig_y = self.orig_res
        x0, x1, x2, x3 = 0, self.left, orig_x - self.right, orig_x
        y0, y1, y2, y3 = 0, self.top, orig_y - self.bottom, orig_y
        for xs, ys in (
            ((x0, x1), (y0, y1)),  # tl
            ((x1, x2), (y0, y1)),  # tm
            ((x2, x3), (y0, y1)),  # tr
            ((x2, x3), (y1, y2)),  # mr
            ((x0, x1), (y2, y3)),  # bl
            ((x1, x2), (y2, y3)),  # bm
            ((x2, x3), (y2, y3)),  # br
            ((x0, x1), (y1, y2)),  # ml
        ):
            for x in range(*xs):
                for y in range(*ys):
                    yield (x, y)

    def eroded(self) -> "Crop | None":
        """Shrink by 1px on every side; None if degenerate. crop.rs:161-177."""
        left, right = self.left + 1, self.right + 1
        top, bottom = self.top + 1, self.bottom + 1
        if left + right >= self.orig_res[0]:
            return None
        if top + bottom >= self.orig_res[1]:
            return None
        return Crop(self.orig_res, left, right, top, bottom)

    def is_uncropped(self) -> bool:
        return self.left == 0 and self.right == 0 and self.top == 0 and self.bottom == 0

    # -- folds ---------------------------------------------------------------

    @staticmethod
    def enormous() -> "Crop":
        """Sentinel for union-folds (crop.rs:185-196)."""
        big = (1 << 32) - 1
        return Crop((big, big), big // 8, big // 8, big // 8, big // 8)
