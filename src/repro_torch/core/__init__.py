"""SOCKET math: SimHash packing (:mod:`.hashing`) and the soft-collision
scorer, top-k selection and subset attention (:mod:`.socket`)."""
