"""Export a serving bundle: checkpoint -> ``torch.export`` programs.

Dual-view fusion eval:

    python -m sdumc_tpu_torch.cli.export --checkpoint mosei_..._17.pt \\
        --out_dir ./bundle --batch_size 128 \\
        --combos 64x64x64x64,256x64x256x64,512x64x512x64

``--checkpoint`` takes a reference-format ``.pt`` (as ``cli.infer``);
without it the weights are seeded.

Beam-decode extractor (``--decode``): the feat4 beam-4 engine (split KV
cache, per-step taps) from an HF LLaMA / Vicuna directory, as a prefill,
a step and a finalize program per prompt bucket (``DecodeBundle``):

    python -m sdumc_tpu_torch.cli.export --decode --llm_dir .../vicuna-7b-v1.5 \
        --out_dir ./decode_bundle --prompt_buckets 64,128,256 \
        --gen_batch 8 [--quant w8a8 --kv_quant int8]

Either bundle is exported for ``--device`` (cuda by default; one device
per bundle), and serves from any process that imports
``sdumc_tpu_torch.serve``, with no model code
(``sdumc_tpu_torch/serve/export.py``). ``--platforms`` is parsed for
recipe parity and not read: a torch program is exported for one device.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from sdumc_tpu_torch.cli.common import add_runtime_args

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--combos", type=str,
                   default="64x64x64x64,256x64x256x64,512x64x512x64",
                   help="comma list of audio x text x video x feat4 buckets")
    p.add_argument("--platforms", type=str, default="tpu,cpu",
                   help="parsed for recipe parity; the bundle is exported for --device")
    p.add_argument("--input_dims", type=str, default="1024,4096,1024,4096")
    # ---- beam-decode bundle mode
    p.add_argument("--decode", action="store_true",
                   help="export the feat4 beam-decode engine instead of the fusion eval")
    p.add_argument("--llm_dir", type=str, default=None,
                   help="HF LLaMA / Vicuna checkpoint directory (--decode)")
    p.add_argument("--prompt_buckets", type=str, default="64,128,256")
    p.add_argument("--gen_batch", type=int, default=8)
    p.add_argument("--num_beams", type=int, default=4)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--quant", type=str, default=None, choices=(None, "int8", "w8a8"))
    p.add_argument("--kv_quant", type=str, default=None, choices=(None, "int8"))
    add_runtime_args(p)
    args = p.parse_args(argv)
    if args.decode and not args.llm_dir:
        p.error("--decode needs --llm_dir")

    from sdumc_tpu_torch.cli.common import build_model, resolve_device, set_matmul_precision
    from sdumc_tpu_torch.core.config import ExperimentConfig
    from sdumc_tpu_torch.serve import DecodeBundle, ServingBundle

    device = resolve_device(args.device)
    set_matmul_precision(args.matmul_precision)
    if args.decode:
        from sdumc_tpu_torch.convert.hf_llama import load_hf_llama

        _, llm = load_hf_llama(args.llm_dir, device=device, quant=args.quant,
                               kv_quant=args.kv_quant)
        buckets = tuple(int(b) for b in args.prompt_buckets.split(","))
        bundle = DecodeBundle.build(llm, buckets=buckets, gen_batch=args.gen_batch,
                                    num_beams=args.num_beams,
                                    max_new_tokens=args.max_new_tokens)
        for bucket, seconds in bundle.export_seconds.items():
            print(f"exported prompt bucket {bucket} in {seconds!r} s")
        bundle.save(args.out_dir)
        print(f"exported {len(buckets)} decode programs (gen_batch={args.gen_batch}, "
              f"beams={args.num_beams}) -> {args.out_dir}")
        return 0
    dims = tuple(int(x) for x in args.input_dims.split(","))
    combos = [tuple(int(x) for x in c.split("x")) for c in args.combos.split(",")]

    model = build_model(ExperimentConfig(), dims, device, args.checkpoint)
    bundle = ServingBundle.build(model, dims, combos, args.batch_size)
    for combo, seconds in bundle.export_seconds.items():
        print(f"exported {'x'.join(map(str, combo))} in {seconds!r} s")
    bundle.save(args.out_dir)
    print(f"exported {len(combos)} programs (bs={args.batch_size}, {device.type}) "
          f"-> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
