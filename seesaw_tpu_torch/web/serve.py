"""Serve the session web API with the port:

    python -m seesaw_tpu_torch.web.serve --seesaw_root <root> --save_path <dir> \
        [--config_path <yaml>] [--host 0.0.0.0] [--port 8000] [--device cuda]

The twin of `scripts/session_server.py`. Sessions load their indices onto
`--device` (default `cuda`); without a GPU it exits non-zero unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
import threading

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seesaw_root", required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--config_path", default=None, help="yaml for yaml_* modes")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"serve: no CUDA device for --device {args.device}; pass --device cpu "
              "to serve on the CPU", file=sys.stderr)
        return 2

    from .app import SeesawServer

    app = SeesawServer(args.seesaw_root, args.save_path, device=device,
                       config_path=args.config_path)
    httpd = app.serve(host=args.host, port=args.port)
    print(f"seesaw_tpu_torch session server on {device} listening on "
          f"{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
