"""The distribution design space of a step: logical axes of every tensor
(``specs``) and the rules mapping them onto a mesh (``rules``). The pure
half of the reference's ``repro.sharding``: no mesh object is built here."""
