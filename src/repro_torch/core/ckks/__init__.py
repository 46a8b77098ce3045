"""RNS-CKKS: parameters, encoding, cipher."""
