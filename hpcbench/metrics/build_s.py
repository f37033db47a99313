"""build_s (s): host clock around the program's container build, as users
call it (SBELL.from_scipy; DIA.from_scipy and DiaPallas.from_dia), moved
to the card included."""


def read(rec):
    return rec.build_s
