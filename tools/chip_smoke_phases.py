"""Some phases of ``chip_smoke.py`` alone on a CUDA device: every kernel
built first (as phase 1 builds them), then each named function of
``chip_smoke``, each followed by a ``phase <name>: wall X s, total Y s``
line, and their records as one JSON line. A function gets its arguments
by their names: ``gpu`` the card's line, ``torch`` the module, ``device``
the card, ``kern`` the collision kernels' module (``ops/cuda/collision.py``),
as ``main`` passes them (the model phases 38-50 take ``gpu`` alone,
``_k1a_vs_twin`` all four, ``_berry_kernels_model`` ``kern`` and ``gpu``).

Run from the root of the checkout on a GPU host, for example
``python tools/chip_smoke_phases.py _kreidenweis_on_card
_kreidenweis_float32_vs_float64 _jaruga_on_card`` (phases 43, 43b, 44).
With ``--root DIR`` the phases are those of the ``chip_smoke.py`` in DIR,
another checkout (a parent unpacked with ``git archive``), run from there.
"""

import inspect
import json
import os
import sys

import torch


def main(argv):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--root"]:
        root, argv = os.path.abspath(argv[1]), argv[2:]
        os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke
    from pysdm_tpu_torch.ops.cuda import collision as kern

    if not torch.cuda.is_available():
        print("chip_smoke_phases: torch sees no CUDA device", file=sys.stderr)
        return 2
    phases = [getattr(chip_smoke, name) for name in argv]
    clock = chip_smoke.PhaseClock()
    gpu = chip_smoke.gpu_line()
    print(gpu)
    chip_smoke.build_kernels()
    clock("build")
    given = {"gpu": gpu, "torch": torch, "device": torch.device("cuda"),
             "kern": kern}
    records = {}
    for name, phase in zip(argv, phases):
        names = [p.name for p in inspect.signature(phase).parameters.values()
                 if p.default is inspect.Parameter.empty]
        records[name] = phase(*(given[n] for n in names))
        clock(name)
    print(json.dumps(records, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
