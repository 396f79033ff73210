"""Library walkthrough of the PyTorch/CUDA port: ``examples/demo.py`` on
``pydca_tpu_torch`` — mfDCA + plmDCA on the RF00167 riboswitch family, with
trimming, backmapping, and (optionally) contact-map evaluation against a
PDB structure.

Run:  python examples/demo_torch.py [MSA_FASTA] [REFSEQ_FASTA]
          [--device cuda|cuda:K|cpu] [--pdb FILE --chain X]

Defaults point at the reference checkout's bundled data when present.
From the repository root without an install: ``env PYTHONPATH=.``.
"""

import argparse
import os

DEFAULT_MSA = "/root/reference/examples/MSA_RF00167.fa"
DEFAULT_REF = "/root/reference/examples/ref_RF00167.fa"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("msa", nargs="?", default=DEFAULT_MSA)
    ap.add_argument("refseq", nargs="?", default=DEFAULT_REF)
    ap.add_argument("--biomolecule", default="rna")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:K or cpu (default cuda)")
    ap.add_argument("--pdb", help="PDB file for contact-map evaluation")
    ap.add_argument("--chain", default="X", help="PDB chain id (1y26: X)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--out_dir", default="demo_out", help="where step 5 writes its scores")
    args = ap.parse_args(argv)

    # ---------------------------------------------------------- 1. trimming
    from pydca_tpu_torch.trim import MSATrimmer

    trimmer = MSATrimmer(
        args.msa, biomolecule=args.biomolecule, refseq_file=args.refseq, device=args.device
    )
    trimmed = trimmer.get_msa_trimmed_by_refseq(remove_all_gaps=True)
    print(f"trimmed MSA: {len(trimmed)} sequences, L={len(trimmed[0][1])}")

    # ------------------------------------------------------------ 2. mfDCA
    from pydca_tpu_torch import MeanFieldDCA

    mf = MeanFieldDCA(args.msa, args.biomolecule, pseudocount=0.5, seqid=0.8,
                      device=args.device)
    print(
        f"mfDCA: N={mf.num_sequences} (dedup), L={mf.sequences_len}, "
        f"Meff={mf.effective_num_sequences:.1f}"
    )
    mf_scores = mf.compute_sorted_FN_APC()
    print("mfDCA top 5 FN-APC pairs (0-based):")
    for (i, j), s in mf_scores[:5]:
        print(f"  ({i:3d},{j:3d})  {s:.4f}")

    # ----------------------------------------------------------- 3. plmDCA
    from pydca_tpu_torch import PlmDCA

    plm = PlmDCA(args.msa, args.biomolecule, max_iterations=args.iters, device=args.device)
    plm_scores = plm.compute_sorted_FN_APC()
    print(f"plmDCA ({args.iters} L-BFGS iterations) top 5 FN-APC pairs:")
    for (i, j), s in plm_scores[:5]:
        print(f"  ({i:3d},{j:3d})  {s:.4f}")
    print("stage timings:")
    print(plm.timers.summary())

    # ------------------------------------------------- 4. refseq backmapping
    from pydca_tpu_torch.backmap import SequenceBackmapper

    bm = SequenceBackmapper(
        alignment_data=list(plm.msa.data),
        refseq_file=args.refseq,
        biomolecule=plm.biomolecule,
        device=plm.device,
    )
    mapped = plm.compute_sorted_FN_APC(seqbackmapper=bm)
    print(f"backmapped to refseq coordinates: {len(mapped)} pairs; top 3:")
    for (i, j), s in mapped[:3]:
        print(f"  ({i:3d},{j:3d})  {s:.4f}")

    # ------------------------------------------ 5. contact-map evaluation
    if args.pdb and os.path.exists(args.pdb):
        from pydca_tpu_torch.eval.visualizer import DCAVisualizer

        # write scores to a file the visualizer can read
        os.makedirs(args.out_dir, exist_ok=True)
        dca_file = os.path.join(args.out_dir, "plm_scores.txt")
        with open(dca_file, "w") as fh:
            for (i, j), s in mapped:
                fh.write(f"{i + 1} {j + 1} {s}\n")
        viz = DCAVisualizer(
            args.biomolecule,
            args.chain,
            args.pdb,
            refseq_file=args.refseq,
            dca_file=dca_file,
            linear_dist=4,
            contact_dist=8.0,
        )
        cats = viz.contact_categories()
        tp = len(cats.get("tp", []))
        fp = len(cats.get("fp", []))
        print(f"contact map vs PDB: {tp} true / {fp} false positives "
              f"in top {tp + fp} predictions")
    else:
        print("(no --pdb given: skipping contact-map evaluation)")


if __name__ == "__main__":
    main()
