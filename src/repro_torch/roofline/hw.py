"""Target hardware constants: one NVIDIA H100 SXM5 80 GB, the card the port
runs on (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
on it printed ``NVIDIA H100 80GB HBM3, 700.00 W``). The reference's names
are kept, so that ``roofline.analysis`` reads either module."""

#: dense bf16 tensor-core rate, FLOP/s (NVIDIA H100 SXM data sheet, an FMA
#: counted as two; the sparse figure is twice this), for the card that
#: prints "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, B/s (NVIDIA H100 SXM data sheet), for "NVIDIA H100 80GB
#: HBM3, 700.00 W"
HBM_BW = 3.35e12
#: per-device collective bandwidth, B/s. The reference's ``ICI_BW`` is one
#: TPU link. Both production meshes (16 x 16 and 2 x 16 x 16 cards) span
#: 8-card NVLink nodes on both axes, so a collective over either axis
#: crosses the network: one 400 Gb/s ConnectX-7 NIC per GPU in a DGX H100
#: (NVIDIA DGX H100 user guide), 50e9 B/s, for "NVIDIA H100 80GB HBM3,
#: 700.00 W" cards.
ICI_BW = 50e9
#: device memory, bytes: ``torch.cuda.get_device_properties(0).
#: total_memory`` on "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES = 85_017_493_504
