"""varlociraptor-tpu: a Bayesian variant-calling engine in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
varlociraptor/varlociraptor (Rust reference): per-read allele-likelihood
extraction (pair-HMM realignment), grammar-defined Bayesian event posteriors
over allele-frequency grids, artifact/bias modeling, FDR-controlled
filtration — batched over candidate loci and sharded over device meshes.

Layering (mirrors SURVEY.md L0-L8, redesigned tensor-first):

- ``io``         host-side genome/alignment/candidate I/O (FASTA, BAM, VCF)
- ``utils``      log-space numerics substrate (numpy + jax twins)
- ``evidence``   pileup extraction -> fixed-shape observation tensors
- ``ops``        device kernels: pair-HMM, likelihood, prior, posterior
- ``grammar``    scenario YAML -> normalized formulas -> tensor event programs
- ``calling``    preprocess / call drivers
- ``filtration`` FDR control, posterior odds
- ``estimation`` alignment properties, contamination, mutational burden
- ``parallel``   device-mesh sharding of the locus batch dimension
"""

__version__ = "0.1.0"
