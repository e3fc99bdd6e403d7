"""The reference's examples (`examples/`) on the port.

* quickstart.py            — DeKRR-DDRF on the houses stand-in against
                             its limit point and the DKLA baseline
* decentralized_readout.py — a frozen backbone's pooled logits as
                             features, per-node DDRF and consensus

Each runs as ``python -m repro_torch.examples.<name>`` on the CUDA card
unless ``--device`` names another device.
"""
