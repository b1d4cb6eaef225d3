"""Trajectory annotation parsers.

A numpy copy of socialways_tpu/data/parsers.py:30-317 (reference
utils/parse_utils.py:79-410), giving what that package's default ``load()``
gives:

- ``TrajnetParser``  rows ``ts id x y``
- ``SDDParser``      Stanford Drone ``id x1 y1 x2 y2 ts …`` (alias
  ``SDD_Parsrer``, the reference's spelling)
- ``BIWIParser``     ETH/UCY obsmat ``ts id px pz py vx vz vy`` — position
  from columns 2, 4 and velocity from 5, 7; the frame interval is detected
- ``SeyfriedParser`` header (obstacles + fps) then ``id ts x y z`` in cm with
  finite-difference velocities

Formats with a ``_table_layout`` (Trajnet, BIWI) are read as a numeric
table, the semantics of the JAX package's C++ table parser
(socialways_tpu/native/fastload.cpp:31-78), which its ``load()`` uses by
default: space, tab, CR and LF always delimit, whatever the parser's own
delimiter (so a space-separated 'zara' obsmat parses, although the BIWI
rule switches the delimiter to a tab); a row with a non-numeric token is
skipped; a row whose column count differs from the first data row's is
skipped.  SDD and Seyfried keep the line loop.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from socialways_torch.data.scale import Scale

_DELIMS = re.compile(r"[ \t\r\n]+")


def _parse_table(path: str) -> np.ndarray:
    """A numeric text table as [rows, cols] float64: rows split on LF only,
    rows with a non-numeric token or another column count than the first
    data row skipped."""
    rows: List[List[float]] = []
    ncols = -1
    with open(path, "rb") as fh:
        for raw in fh:
            try:
                vals = [float(tok) for tok in
                        _DELIMS.split(raw.decode("latin-1")) if tok]
            except ValueError:
                continue
            if not vals:
                continue
            if ncols < 0:
                ncols = len(vals)
            if len(vals) != ncols:
                continue
            rows.append(vals)
    return np.asarray(rows, np.float64).reshape(len(rows), max(ncols, 1))


def _expand_glob(filename: str) -> List[str]:
    """'<dir>/*<ext>' lists files in <dir> ending with <ext> (reference
    glob behavior, parse_utils.py:97-106); otherwise the literal path."""
    if "*" not in filename:
        return [filename]
    star = filename.index("*")
    files_path, extension = filename[:star], filename[star + 1:]
    return [files_path + f for f in sorted(os.listdir(files_path))
            if f.endswith(extension)]


class _BaseParser:
    """Shared per-agent accumulation + scale fitting."""

    #: default frame interval between consecutive annotated timestamps
    interval: int = 1
    default_down_sample: int = 1
    #: column layout of the table path:
    #: (n_cols_min, id_col, ts_col, px_col, py_col, vx_col, vy_col);
    #: None = the line loop
    _table_layout = None

    def __init__(self) -> None:
        self.scale = Scale()
        self.all_ids: List[int] = []
        self.p_data: List[np.ndarray] = []   # per-agent [Ti, 2] positions
        self.v_data: List[np.ndarray] = []   # per-agent [Ti, 2] velocities (may be empty)
        self.t_data: List[np.ndarray] = []   # per-agent [Ti] int timestamps
        self.min_t: float = float("inf")
        self.max_t: float = -1.0
        self.actual_fps: float = 0.0
        self.delimit: str = " "

    # row decoder: returns (agent_id, ts, px, py, vx_or_None, vy_or_None)
    # or None to skip the row.
    def _decode(self, row: Sequence[str]
                ) -> Optional[Tuple[int, float, float, float,
                                    Optional[float], Optional[float]]]:
        raise NotImplementedError

    def _pre_file(self, filename: str) -> None:
        """Per-file hook (e.g. delimiter switching)."""

    def load(self, filename: str, down_sample: Optional[int] = None):
        """Parse ``filename`` (glob patterns supported)."""
        if down_sample is None:
            down_sample = self.default_down_sample
        pos, vel, tim = {}, {}, {}
        order: List[int] = []
        self.all_ids.clear()

        if self._table_layout is not None and self._load_table(
                filename, down_sample, pos, vel, tim, order):
            self._finalize(pos, vel, tim, order)
            return self

        # the line loop; also where a table narrower than the layout falls
        # back, keeping what earlier files added, as the JAX package does
        for file in _expand_glob(filename):
            if not os.path.exists(file):
                raise ValueError(f"No such file or directory: {file}")
            self._pre_file(file)
            with open(file, "r") as fh:
                for line in fh:
                    row = [tok for tok in line.split(self.delimit) if tok.strip()]
                    dec = self._decode(row)
                    if dec is None:
                        continue
                    aid, ts, px, py, vx, vy = dec
                    # keep one sample every `down_sample` frames
                    if ts % down_sample != 0:
                        continue
                    self.min_t = min(self.min_t, ts)
                    self.max_t = max(self.max_t, ts)
                    if aid not in pos:
                        order.append(aid)
                        pos[aid], vel[aid], tim[aid] = [], [], []
                        self.all_ids.append(aid)
                    pos[aid].append((px, py))
                    if vx is not None:
                        vel[aid].append((vx, vy))
                    tim[aid].append(ts)

        self._finalize(pos, vel, tim, order)
        return self

    def _load_table(self, filename: str, down_sample: int, pos, vel, tim,
                    order) -> bool:
        """Load through the table semantics.  Returns False when a file's
        table is narrower than the layout (the line loop then runs)."""
        ncols, id_c, ts_c, px_c, py_c, vx_c, vy_c = self._table_layout
        for file in _expand_glob(filename):
            if not os.path.exists(file):
                raise ValueError(f"No such file or directory: {file}")
            self._pre_file(file)
            table = _parse_table(file)
            if table.shape[0] == 0:
                continue
            if table.shape[1] < ncols:
                return False
            table = table[np.mod(table[:, ts_c], down_sample) == 0]
            if table.shape[0] == 0:
                continue
            ts = table[:, ts_c]
            self.min_t = min(self.min_t, float(ts.min()))
            self.max_t = max(self.max_t, float(ts.max()))
            ids = np.round(table[:, id_c]).astype(np.int64)
            for aid in ids[np.sort(np.unique(ids, return_index=True)[1])]:
                aid = int(aid)
                if aid not in pos:
                    order.append(aid)
                    pos[aid], vel[aid], tim[aid] = [], [], []
                    self.all_ids.append(aid)
            for k in range(table.shape[0]):
                aid = int(ids[k])
                pos[aid].append((table[k, px_c], table[k, py_c]))
                if vx_c >= 0:
                    vel[aid].append((table[k, vx_c], table[k, vy_c]))
                tim[aid].append(ts[k])
        return True

    def _finalize(self, pos, vel, tim, order) -> None:
        for aid in order:
            self.p_data.append(np.asarray(pos[aid], dtype=np.float64))
            if vel[aid]:
                self.v_data.append(np.asarray(vel[aid], dtype=np.float64))
            self.t_data.append(np.asarray(tim[aid]).astype(np.int32))

        self._post_load()

        for p in self.p_data:
            self.scale.fit(p)
        self.scale.calc_scale(keep_ratio=True)

    def _post_load(self) -> None:
        """Hook after accumulation (e.g. interval auto-detection)."""


class TrajnetParser(_BaseParser):
    """TrajNet txt: ``ts id x y`` per row (parse_utils.py:79-147)."""

    interval = 6
    _table_layout = (4, 1, 0, 2, 3, -1, -1)

    def _decode(self, row):
        if len(row) < 4:
            return None
        ts = float(row[0])
        aid = round(float(row[1]))
        return aid, ts, float(row[2]), float(row[3]), None, None


class SDDParser(_BaseParser):
    """Stanford Drone annotations: ``id xmin ymin xmax ymax ts …`` — position
    is the bbox center; fps 2.5 at down_sample=12 (parse_utils.py:150-228).
    No table path: real SDD rows end with a quoted label."""

    interval = 12
    default_down_sample = 12

    def _pre_file(self, filename: str) -> None:
        self.actual_fps = 2.5

    def _decode(self, row):
        if len(row) < 10:
            return None
        aid = round(float(row[0]))
        ts = float(row[5])
        px = (round(float(row[1])) + round(float(row[3]))) / 2
        py = (round(float(row[2])) + round(float(row[4]))) / 2
        return aid, ts, px, py, None, None


class BIWIParser(_BaseParser):
    """ETH/UCY obsmat: ``ts id px pz py vx vz vy`` — position from columns
    (2, 4), velocity from (5, 7); 'zara' files are tab-delimited; the frame
    interval is auto-detected from the first agent with >1 samples
    (parse_utils.py:231-320)."""

    interval = -1
    _table_layout = (8, 1, 0, 2, 4, 5, 7)

    def _pre_file(self, filename: str) -> None:
        if "zara" in filename:
            self.delimit = "\t"

    def _decode(self, row):
        if len(row) < 8:
            return None
        ts = float(row[0])
        aid = round(float(row[1]))
        return (aid, ts, float(row[2]), float(row[4]),
                float(row[5]), float(row[7]))

    def _post_load(self) -> None:
        for t in self.t_data:
            if len(t) > 1:
                iv = int(round(float(t[1] - t[0])))
                if iv > 0:
                    self.interval = iv
                    break


class SeyfriedParser(_BaseParser):
    """Seyfried experiment format: a header (n_obstacles, obstacle coords,
    fps) followed by ``id ts x y z`` rows in centimeters; velocities are
    finite differences scaled by fps (parse_utils.py:323-410).

    ``load`` also returns ``(p_data, v_data, t_data)`` like the reference.
    """

    def __init__(self) -> None:
        super().__init__()
        self._fps = 1.0
        self._line_no = 0
        self._last: dict = {}

    def load(self, filename: str, down_sample: Optional[int] = None):
        if down_sample is None:
            down_sample = 4
        self._down_sample = down_sample
        self._line_no = 0
        super().load(filename, down_sample)
        return self.p_data, self.v_data, self.t_data

    def _decode(self, row):
        self._line_no += 1
        if self._line_no == 4 and row:
            self._fps = float(row[0])
            self.actual_fps = self._fps / self._down_sample
        if len(row) != 5:
            return None
        aid = row[0]
        ts = float(row[1])
        if ts % self._down_sample != 0:
            return None
        px = float(row[2]) / 100.0
        py = float(row[3]) / 100.0
        last_px, last_py, last_t = self._last.get(aid, (px, py, ts))
        dt = ts - last_t + np.finfo(float).eps
        vx = (px - last_px) * self._fps / dt
        vy = (py - last_py) * self._fps / dt
        self._last[aid] = (px, py, ts)
        # string ids become ints through hash(): stable within one process
        try:
            iid = int(aid)
        except ValueError:
            iid = hash(aid)
        return iid, ts, px, py, vx, vy

    def _post_load(self) -> None:
        # auto-detect the post-down-sampling frame interval (without it the
        # windowing would look for stride-1 frames that don't exist)
        for t in self.t_data:
            if len(t) > 1:
                iv = int(round(float(t[1] - t[0])))
                if iv > 0:
                    self.interval = iv
                    return


# Reference-compatible (sic) alias, parse_utils.py:150.
SDD_Parsrer = SDDParser

#: ``--parser`` names of the CLI
PARSERS = {"biwi": BIWIParser, "trajnet": TrajnetParser, "sdd": SDDParser,
           "seyfried": SeyfriedParser}
