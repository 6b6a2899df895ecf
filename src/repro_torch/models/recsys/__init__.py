"""The port of `repro.models.recsys`: the concatenated embedding table
with its single-hot lookup and weighted bag (`embedding`, the bag on
kernel B6) and xDeepFM (`xdeepfm`)."""
