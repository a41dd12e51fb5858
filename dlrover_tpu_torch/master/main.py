"""Master process entry: ``python -m dlrover_tpu_torch.master.main``. The
port's own copy of dlrover_tpu/master/main.py, for ``--platform local``."""

from __future__ import annotations

import os
import sys

from dlrover_tpu_torch.master.args import parse_master_args
from dlrover_tpu_torch.master.local_master import LocalJobMaster


def run(args) -> int:
    master = LocalJobMaster(
        port=args.port,
        node_num=args.node_num,
        heartbeat_timeout=args.heartbeat_timeout,
    )
    master.prepare()
    if args.port_file:
        # written whole, then renamed: the launcher never reads a part
        tmp = f"{args.port_file}.tmp"
        with open(tmp, "w") as f:
            f.write(str(master.port))
        os.replace(tmp, args.port_file)
    return master.run()


def main(argv=None) -> int:
    return run(parse_master_args(argv))


if __name__ == "__main__":
    sys.exit(main())
