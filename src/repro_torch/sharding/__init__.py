"""The distribution design space of a step: logical axes of every tensor
(``specs``) and the rules mapping them onto a mesh (``rules``: the pure
resolution, and the DTensor placements of a resolved spec), and the
activation constraints that apply them inside a step (``act``)."""
