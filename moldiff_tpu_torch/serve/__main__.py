"""Serve molecule generation over HTTP from a trained checkpoint
(scripts/serve_sampler.py): the model is loaded once, one short chain per
bucket warms the kernels, then POST /generate requests are answered. See
moldiff_tpu_torch/serve/server.py for the API.

    python -m moldiff_tpu_torch.serve --ckpt ckpts/flagship_v2.ckpt --num_steps 100 --port 8000
    curl -s localhost:8000/health
    curl -s -X POST localhost:8000/generate -d '{"num_mols": 8, "seed": 1, "format": "sdf"}'
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, help="denoiser checkpoint")
    p.add_argument("--bond_ckpt", default=None, help="bond predictor checkpoint")
    p.add_argument("--guidance", nargs=2, metavar=("TYPE", "SCALE"), default=None,
                   help="e.g. uncertainty 1e-4")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--buckets", type=int, nargs="+", default=None)
    p.add_argument("--max_mols_per_request", type=int, default=1024)
    p.add_argument("--guidance_interval", type=int, default=1)
    p.add_argument("--num_steps", type=int, default=None,
                   help="respaced reverse chain of S steps")
    p.add_argument("--pos_sampler", choices=["ddpm", "ddim"], default="ddpm")
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM noise level (0 deterministic, 1 the ddpm posterior)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="coalesce concurrent unseeded requests arriving within this window")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup chains (the first request then builds the kernels)")
    args = p.parse_args(argv)

    guidance = None
    if args.guidance:
        if not args.bond_ckpt:
            raise SystemExit("--guidance requires --bond_ckpt")
        guidance = (args.guidance[0], float(args.guidance[1]))

    from .server import build_service_from_checkpoint, make_http_server

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("serve")
    service = build_service_from_checkpoint(
        args.ckpt, bond_ckpt_path=args.bond_ckpt, guidance=guidance, use_ema=args.use_ema,
        batch_size=args.batch_size, buckets=args.buckets,
        max_mols_per_request=args.max_mols_per_request,
        guidance_interval=args.guidance_interval, num_steps=args.num_steps,
        pos_sampler=args.pos_sampler, eta=args.eta, batch_window_ms=args.batch_window_ms,
        device=args.device)
    if not args.no_warmup:
        service.warmup(logger=logger)
    server = make_http_server(service, args.host, args.port, logger=logger)
    logger.info(f"serving on http://{args.host}:{server.server_port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
