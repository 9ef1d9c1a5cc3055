"""fastquick_tpu_torch: FASTQuick's align path in PyTorch with CUDA kernels.

A port of ``fastquick_tpu`` (the JAX/Pallas package beside it, which stays
the reference) to PyTorch on an NVIDIA H100:

- Host Python/C++ handles file formats (FASTA/FASTQ/VCF/SAM/BAM) and
  orchestration; those modules are kept as byte-identical copies.
- The device runs the numeric cores of ``align --device_qc``: the k-mer
  read filter, the ``bwt_cal_width`` precompute, the best-first inexact FM
  search, the mate-rescue Smith-Waterman forward pass and the dense
  per-base statistics.  The width, search and SW kernels are CUDA C++ for
  ``sm_90a`` (``csrc/``), built with nvcc at first use; each has a plain
  PyTorch version beside it that runs when the tensors lie on the CPU.
"""

__version__ = "0.1.0"

PACKAGE_VERSION = "1.0.0-tpu"  # written into .SelectedSite.vcf headers
