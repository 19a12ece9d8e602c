"""Small cells for the CPU tests: the benchmark's own configurations and
mixes at a size a test run holds, the program on the CPU."""
import copy

from portbench import harness


def small_cell(name: str, width: int = 96, height: int = 64,
               segment: int = 4, chunk: int = 2, **traffic):
    """The spec's cell ``name`` at width x height, with a segment of
    ``segment`` pictures (one IDR period) in chunks of ``chunk``."""
    cell = harness.Cell.load(harness.load_spec(), name)
    cell = copy.copy(cell)
    cell.config = dict(cell.config, width=width, height=height,
                       idr_period=segment)
    cell.traffic = dict(cell.traffic, segment=segment, chunk=chunk,
                        check_workers=2, **traffic)
    return cell
